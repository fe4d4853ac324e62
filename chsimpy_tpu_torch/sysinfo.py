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


def card_line() -> str:
    """The first card's name and power limit as ``nvidia-smi`` gives them
    (``name, power.limit``): the label every time on the card carries."""
    import subprocess
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]
