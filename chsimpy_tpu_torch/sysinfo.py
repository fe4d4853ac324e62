"""Host utilities: the file id, human-readable times, the host and device
descriptions the bench and the experiment write into their files, the
process's peak memory, an object's attributes as "key, value" lines and
whether the run is in a notebook (``chsimpy_tpu/sysinfo.py``'s, without
psutil)."""

from __future__ import annotations

import os
import platform
import sys
import time
from datetime import datetime

from .version import __version__


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


def get_int_max_value() -> int:
    """The live loop's step bound when a simulated time limit ends it."""
    import numpy as np
    return int(np.iinfo(np.intp).max)


def get_mem_usage_all() -> str:
    """Peak resident memory of this process and its waited-for children
    (``resource``'s maxrss, KiB on Linux) in MiB."""
    import resource
    kib = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
           + resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss)
    return f"{kib / 1024:0.2f}MiB"


def vars_to_list(obj) -> list:
    """The public, non-callable attributes of ``obj`` as "name, value"
    lines, in ``dir`` order."""
    attribs = []
    for x in dir(obj):
        if x.startswith('_') or not hasattr(obj, x):
            continue
        v = getattr(obj, x)
        if callable(v):
            continue
        attribs.append(f"{x}, {v}")
    return attribs


def get_system_info() -> list:
    """The host, as "key, value" lines (``chsimpy_tpu/sysinfo.py``'s
    keys without psutil's core and clock counts: the card's machine has
    no psutil)."""
    uname = platform.uname()
    return [
        f"system, {uname.system}",
        f"nodename, {uname.node}",
        f"kernel-release, {uname.release}",
        f"kernel-version, {uname.version}",
        f"machine, {uname.machine}",
        f"cores_total, {os.cpu_count()}",
        f"localtime, {time.strftime('%Y-%m-%d %H:%M:%S %Z')}",
        f"argv, '{' '.join(sys.argv)}'",
        f"chsimpy-tpu-torch-version, {__version__}",
    ]


def get_device_info(device) -> list:
    """The run's device as "key, value" lines: on the card its name and
    power limit (:func:`card_line`) and the card count, then the torch and
    CUDA versions."""
    import torch
    dev = torch.device(device)
    if dev.type == 'cuda':
        info = [f"card, {card_line()}",
                f"device-count, {torch.cuda.device_count()}"]
    else:
        info = [f"device, {dev.type}"]
    return info + [f"torch, {torch.__version__}",
                   f"cuda, {torch.version.cuda}"]


def is_notebook() -> bool:
    """True inside a Jupyter kernel (the views draw inline there)."""
    try:
        from IPython import get_ipython
    except ImportError:
        return False
    try:
        shell = get_ipython().__class__.__name__
        return shell == 'ZMQInteractiveShell'
    except NameError:
        return False
