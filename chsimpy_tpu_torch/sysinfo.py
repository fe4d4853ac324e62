"""Host utilities the simulator uses (file id, human-readable times)."""

from __future__ import annotations

from datetime import datetime


def get_or_create_file_id(file_id):
    if file_id == 'auto' or file_id is None or file_id == '' \
            or str(file_id).lower() == 'none':
        return datetime.now().strftime('%d%m%Y-%H%M%S')
    return file_id


def sec_to_min_if(value, t=60):
    if value > t:
        return str(round(value / 60.0, 1)) + 'min'
    return str(round(value, 1)) + 's'
