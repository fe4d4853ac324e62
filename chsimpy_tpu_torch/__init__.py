"""chsimpy_tpu_torch — the Cahn-Hilliard phase-separation engine in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (H100).

A port of the JAX package ``chsimpy_tpu`` (which stays the reference): the
single-device solve of the Cahn-Hilliard equation with a Flory-Huggins
energy, semi-implicit DCT-spectral steps and the energy early stop.  The
package imports torch and never jax.  Every run names its device
(``Parameters.device``): on 'cuda' the step runs the kernels of
``csrc/ch_kernels.cu``, on 'cpu' their plain PyTorch versions.
"""

from .params import Parameters  # noqa: F401
from .solution import Solution  # noqa: F401
from .timedata import TimeData  # noqa: F401
from .core.solver import Solver  # noqa: F401
from .simulator import Simulator  # noqa: F401
from .cli import CLIParser  # noqa: F401
from .version import __version__  # noqa: F401

__all__ = ['Parameters', 'Solution', 'TimeData', 'Solver', 'Simulator',
           'CLIParser', '__version__']
