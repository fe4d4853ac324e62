"""Host utilities: the file id, human-readable times, the host and device
descriptions the bench and the experiment write into their files (the
card's topology among them), the process's memory, an object's
attributes as "key, value" lines and whether the run is in a notebook
(``chsimpy_tpu/sysinfo.py``'s, from ``os``, ``resource`` and ``/proc``:
the card's machine has no psutil)."""

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


def get_current_localtime() -> str:
    return time.strftime("%Y-%m-%d %H:%M:%S %Z", time.localtime())


def get_number_physical_cores() -> int:
    """The host's physical cores: the distinct (physical id, core id)
    pairs of ``/proc/cpuinfo`` (psutil's count on Linux), or the logical
    count where it names none."""
    cores, phys, core = set(), None, None
    try:
        with open('/proc/cpuinfo') as f:
            for line in list(f) + ['\n']:
                key, _, value = line.partition(':')
                key = key.strip()
                if key == 'physical id':
                    phys = value.strip()
                elif key == 'core id':
                    core = value.strip()
                elif not key:               # a processor's block ends
                    if core is not None:
                        cores.add((phys, core))
                    phys = core = None
    except OSError:
        pass
    return len(cores) or os.cpu_count() or 1


def get_mem_usage() -> str:
    """This process's resident memory (``/proc/self/statm``) in MiB."""
    with open('/proc/self/statm') as f:
        pages = int(f.read().split()[1])
    return f"{pages * os.sysconf('SC_PAGE_SIZE') / 1048576:.2f}MiB"


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
    keys but psutil's clock rates: the card's machine has no psutil)."""
    uname = platform.uname()
    return [
        f"system, {uname.system}",
        f"nodename, {uname.node}",
        f"kernel-release, {uname.release}",
        f"kernel-version, {uname.version}",
        f"machine, {uname.machine}",
        f"cores_phys, {get_number_physical_cores()}",
        f"cores_total, {os.cpu_count()}",
        f"localtime, {get_current_localtime()}",
        f"argv, '{' '.join(sys.argv)}'",
        f"chsimpy-tpu-torch-version, {__version__}",
    ]


def get_device_info(device) -> list:
    """The run's device and its topology as "key, value" lines, the JAX
    package's keys: ``device-count`` (the cards visible; 1 on the CPU),
    ``local-device-count`` (the devices this process drives: one, a
    process a device), ``process-count`` (the world size of an
    initialized process group, else 1), ``device-kind`` (the card's
    name); on the card its name and power limit (:func:`card_line`);
    then the torch and CUDA versions."""
    import torch
    import torch.distributed as dist
    dev = torch.device(device)
    procs = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    if dev.type == 'cuda':
        info = [f"card, {card_line()}",
                f"device-count, {torch.cuda.device_count()}",
                f"device-kind, {torch.cuda.get_device_name(dev)}"]
    else:
        info = [f"device, {dev.type}", "device-count, 1",
                f"device-kind, {dev.type}"]
    return info + ["local-device-count, 1", f"process-count, {procs}",
                   f"torch, {torch.__version__}",
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
