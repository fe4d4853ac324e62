"""The plain reference: a Cahn–Hilliard integrator in plain PyTorch.

Written from the model's equations, not from the port: the 2-D DCT-II as
products with an explicit cosine matrix, the Flory–Huggins chemical
potential with the linear Redlich–Kister interaction, the semi-implicit
spectral update of Ghiass et al. (2016), eq. (12), the statistics rows and
the energy stop of upstream chsimpy
(https://github.com/uncertaintyhub/chsimpy).
It imports nothing of the port and takes none of its constants: every grid
is built here from the configuration's published parameters.

The solve semantics are upstream chsimpy's, which the port keeps:

* row 0 holds the statistics of the initial field; the step counter starts
  at 1, and a row is written per step with ``it`` = the counter before it
  advances;
* the spectral image is recomputed from U at every entry of a solve;
* a member stops at the first step whose E2 lies below the previous row's
  and above row 0's (``E2[it-1] > E2[it] > E2[0]``); that step counts, its
  row is written, ``tau0`` is the counter after it; a stopped member is
  frozen.  With ``full_sim`` no member stops.

``dtype`` is float64 for the reference; ``precision='tf32'`` computes the
products in float32 with their operands rounded to TF32 (10 mantissa
bits), the form of the benchmark's lower-precision control.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

ROW_COLUMNS = ('it', 'E', 'E2', 'SA', 'domtime', 'Ra', 'L2', 'PS', 'delt')


@dataclass(frozen=True)
class Physics:
    """The configuration's physical parameters (upstream defaults)."""
    N: int
    L: float = 2.0
    temp: float = 923.15
    B: float = 12.86
    R: float = 0.0083144626181532
    N_A: float = 6.02214076e+23
    delt: float = 3e-8
    M_tilde: float = 1.71e-8
    threshold: float = 0.875

    @classmethod
    def from_params(cls, params: dict) -> 'Physics':
        keys = cls.__dataclass_fields__
        return cls(**{k: params[k] for k in keys if k in params})


def cosine_matrix(N: int, dtype=torch.float64, device='cpu') -> torch.Tensor:
    """C[k, n] = s_k cos(pi (2n + 1) k / (2N)), s_0 = sqrt(1/N), else
    sqrt(2/N): the orthonormal DCT-II.  The angle's integer part is
    reduced modulo 4N before the cosine, so each entry is exact to float64
    rounding at any N."""
    k = np.arange(N, dtype=np.int64)[:, None]
    n = np.arange(N, dtype=np.int64)[None, :]
    m = ((2 * n + 1) * k) % (4 * N)
    C = np.cos(np.pi * m / (2.0 * N)) * math.sqrt(2.0 / N)
    C[0, :] = math.sqrt(1.0 / N)
    return torch.as_tensor(C).to(device=device, dtype=dtype)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to the nearest TF32 value (10 mantissa bits,
    ties away from zero), returned as float32."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class Reference:
    """R members of one configuration, stepped together.

    ``A0``, ``A1``, ``kappa_tilde``: (R,) per-member values (float64).
    ``precision``: 'float64', 'float32' or 'tf32' (the products in float32
    with TF32 operands)."""

    def __init__(self, phys: Physics, A0, A1, kappa_tilde, device='cpu',
                 precision: str = 'float64', full_sim: bool = False):
        self.phys = phys
        self.device = torch.device(device)
        self.precision = precision
        self.dtype = torch.float64 if precision == 'float64' else \
            torch.float32
        self.full_sim = full_sim
        f64 = torch.float64
        N = phys.N
        self.A0 = torch.as_tensor(A0, dtype=f64).reshape(-1, 1, 1)
        self.A1 = torch.as_tensor(A1, dtype=f64).reshape(-1, 1, 1)
        self.kt = torch.as_tensor(kappa_tilde, dtype=f64).reshape(-1, 1, 1)
        self.A0, self.A1, self.kt = (t.to(self.device) for t in
                                     (self.A0, self.A1, self.kt))
        self.R = self.A0.shape[0]
        self.Am = (25.13e6 / phys.N_A) ** (2.0 / 3.0) * phys.N_A
        self.delx = phys.L / (N - 1)
        self.RT = phys.R * phys.temp
        self.C = cosine_matrix(N, self.dtype, self.device)
        if precision == 'tf32':
            self.C = round_tf32(self.C)
        # eigenvalues of the no-flux Laplacian in upstream's (N-1)
        # convention, and the update's grids of each member
        e = 2.0 * torch.cos(math.pi * torch.arange(N, dtype=f64) / (N - 1)) \
            - 2.0
        leig = (e[:, None] + e[None, :]).to(self.device)
        lam1 = phys.delt / self.delx ** 2
        lam2 = self.kt * lam1 / self.delx ** 2
        self.CHeig = (1.0 + lam2 * leig * leig).to(self.dtype)
        self.Seig = (lam1 * leig).to(self.dtype)

    # -- the operators ---------------------------------------------------
    def _mm(self, a, b):
        if self.precision == 'tf32':
            a, b = round_tf32(a), round_tf32(b)
        return torch.matmul(a, b)

    def dct2(self, U):
        return self._mm(self._mm(self.C, U), self.C.T)

    def idct2(self, X):
        return self._mm(self._mm(self.C.T, X), self.C)

    def mu(self, U):
        """The nonlinear chemical potential, in U's type:
        RT·ln(U/(1−U)) − B·RT + (A0 + A1(1−2U))(1−2U) − 2·A1·U(1−U)."""
        RT = self.RT
        A0, A1 = self.A0.to(U.dtype), self.A1.to(U.dtype)
        return (RT * torch.log(U / (1.0 - U)) - self.phys.B * RT
                + (A0 + A1 * (1.0 - 2.0 * U)) * (1.0 - 2.0 * U)
                - 2.0 * A1 * U * (1.0 - U))

    def gradient_sq(self, U):
        """|∇U|² with numpy's ``gradient`` stencil (edge_order=1)."""
        h = self.delx

        def d(V):
            return torch.cat([(V[..., 1:2, :] - V[..., 0:1, :]) / h,
                              (V[..., 2:, :] - V[..., :-2, :]) / (2.0 * h),
                              (V[..., -1:, :] - V[..., -2:-1, :]) / h],
                             dim=-2)
        gx = d(U)
        gy = d(U.mT).mT
        return gx * gx + gy * gy

    def stats(self, U, mu=None):
        """(E, E2, SA, Ra, L2, PS) of every member, (R,) float64."""
        f64 = torch.float64
        p = self.phys
        N = p.N
        U = U.to(f64)
        Lsq = p.L ** 2
        integrand = (self.RT * (U * (torch.log(U) - p.B)
                                + (1.0 - U) * torch.log(1.0 - U))
                     + (self.A0 + self.A1 * (1.0 - 2.0 * U)) * U * (1.0 - U))
        mean = lambda x: x.mean(dim=(-2, -1))          # noqa: E731
        E2 = 0.5 / self.Am * self.kt.reshape(-1) * Lsq \
            * mean(self.gradient_sq(U))
        E = Lsq / self.Am * mean(integrand) + E2
        SA = mean((U < p.threshold).to(f64))
        mid = U[..., N // 2 + 1, :]
        Ra = (mid - mid.mean(dim=-1, keepdim=True)).abs().mean(dim=-1)
        PS = mean((U - mean(U)[:, None, None]).abs())
        if mu is None:
            L2 = torch.zeros_like(E)
        else:
            L2 = torch.sqrt((mu.to(f64) ** 2).sum(dim=(-2, -1))) / N ** 2
        return E, E2, SA, Ra, L2, PS

    # -- the solve ---------------------------------------------------------
    def run(self, U0, n_iters: int, start_step: int = 1, entries=(),
            E2_first=None, rows0: bool = True):
        """Step every member from ``U0`` ((N, N) or (R, N, N)) through
        ``n_iters`` step iterations (fewer once every member has stopped),
        the counter starting at ``start_step``; the spectral image is
        recomputed from U at the start and at each counter value in
        ``entries``.  ``rows0``: write row 0 (a fresh solve).
        ``E2_first``: row 0's E2 where the solve does not start fresh
        (None: the start's).

        Returns a dict of numpy arrays: ``rows`` (R, n, 9) with NaN past a
        member's last row, ``n_rows`` (R,), ``computed_steps``, ``tau0``,
        ``t0``, ``stopped`` (R,) and ``U`` the members' final fields
        (a float64 tensor)."""
        f64 = torch.float64
        dev = self.device
        N, R = self.phys.N, self.R
        U = torch.as_tensor(U0).to(device=dev, dtype=f64)
        U = U.expand(R, N, N).clone() if U.dim() == 2 else U.clone()
        U = U.to(self.dtype)
        rows = []
        E, E2, SA, Ra, L2, PS = self.stats(U)
        delt = self.phys.delt
        if rows0:
            zero = torch.zeros(R, dtype=f64, device=dev)
            rows.append(torch.stack([zero, E, E2, zero, zero, Ra, zero, PS,
                                     zero + delt], dim=-1))
        E2_first = (E2.clone() if E2_first is None else
                    torch.as_tensor(E2_first, dtype=f64, device=dev)
                    .expand(R).clone())
        E2_prev = E2_first.clone()
        steps = torch.full((R,), start_step, dtype=torch.int64, device=dev)
        active = torch.ones(R, dtype=torch.bool, device=dev)
        skip = torch.zeros(R, dtype=torch.bool, device=dev)
        tau0 = torch.zeros(R, dtype=f64, device=dev)
        t0 = torch.zeros(R, dtype=f64, device=dev)
        entries = set(int(e) for e in entries)
        hat_U = self.dct2(U)
        for i in range(n_iters):
            c = start_step + i
            if i and c in entries:
                hat_U = self.dct2(U)
            mu = self.mu(U)
            hat_new = (hat_U + self.Seig * self.dct2(mu)) / self.CHeig
            U_new = self.idct2(hat_new)
            E, E2, SA, Ra, L2, PS = self.stats(U_new, mu)
            time_passed = c * delt / self.phys.M_tilde
            row = torch.stack([steps.to(f64), E, E2, SA,
                               E.new_full((R,), time_passed ** (1 / 3)), Ra,
                               L2, PS, E.new_full((R,), delt)], dim=-1)
            rows.append(torch.where(active[:, None], row,
                                    torch.full_like(row, float('nan'))))
            fire = active & ~skip & (E2_prev > E2) & (E2 > E2_first)
            tau0 = torch.where(fire, (steps + 1).to(f64), tau0)
            t0 = torch.where(fire, torch.full_like(t0, time_passed), t0)
            a3 = active[:, None, None]
            U = torch.where(a3, U_new, U)
            hat_U = torch.where(a3, hat_new, hat_U)
            E2_prev = torch.where(active, E2, E2_prev)
            steps = steps + active.to(torch.int64)
            if self.full_sim:
                skip = skip | fire
            else:
                active = active & ~fire
            if not self.full_sim and (i + 1) % 64 == 0 \
                    and not bool(active.any()):
                break
        out = torch.stack(rows, dim=1).cpu().numpy()
        n_rows = np.sum(~np.isnan(out[:, :, 1]), axis=1)
        return {'rows': out, 'n_rows': n_rows,
                'computed_steps': steps.cpu().numpy(),
                'tau0': tau0.cpu().numpy(), 't0': t0.cpu().numpy(),
                'stopped': (~active).cpu().numpy(), 'U': U.to(f64)}
