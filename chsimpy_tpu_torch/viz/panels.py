"""Panel primitives for the diagnostics views
(``chsimpy_tpu/viz/panels.py``).

Each panel owns one axes: ``build(ax)`` creates its artists once,
``update(**data)`` refreshes them.  The view classes compose panels and
handle blitting generically, instead of the reference's one-method-per-panel
monolith (``chsimpy/plotview.py:15-267`` — same six diagnostics, different
architecture).  Panels draw host (numpy) arrays: the simulator copies the
field off the card once per refresh and hands every panel that copy.
"""

from __future__ import annotations

import numpy as np


class Panel:
    blit_artists = ()

    def build(self, ax):
        self.ax = ax

    def update(self, **data):
        raise NotImplementedError


class FieldMap(Panel):
    """U concentration map, binary colormap split at the threshold."""

    def build(self, ax):
        super().build(ax)
        self.image = ax.imshow(np.zeros((2, 2)), cmap='plasma',
                               aspect='equal')
        self.blit_artists = (self.image,)

    def update(self, U=None, threshold=0.875, title=''):
        from matplotlib import colors
        self.ax.set_title(title)
        if U is None:
            return
        cmap = colors.ListedColormap(['orange', 'yellow'])
        self.image.set_cmap(cmap)
        self.image.set_norm(colors.BoundaryNorm([0.0, threshold, 1],
                                                cmap.N, clip=True))
        self.image.set_data(np.real(np.asarray(U)))


class MidRowSlice(Panel):
    """Concentration profile along the U(N/2+1, :) row."""

    def __init__(self, N):
        self.N = N

    def build(self, ax):
        super().build(ax)
        self.line, = ax.plot(np.arange(self.N), np.zeros(self.N))
        ax.set_ylim(0.75, 1)  # 1% initial deviation around c0
        self.blit_artists = (self.line,)

    def update(self, U=None, title=''):
        self.ax.set_title(title)
        if U is None:
            return
        self.line.set_ydata(np.asarray(U)[self.N // 2 + 1, :])
        self.ax.grid(True)
        self.ax.set_ylabel('Concentration')


class EnergyTrace(Panel):
    """Total energy E per step, with an optional delt twin axis
    (adaptive-time mode)."""

    def build(self, ax):
        super().build(ax)
        self.twin = ax.twinx()
        self.line, = ax.plot([], [])
        self.delt_line, = self.twin.plot([], [], color='gray')
        self.twin.get_yaxis().set_visible(False)
        self.blit_artists = (self.line, self.delt_line)

    def update(self, E=None, it_range=None, title='', computed_steps=0,
               delt=None):
        self.ax.set_title(title)
        self.twin.set_ylabel('')
        self.twin.get_yaxis().set_visible(False)
        if E is None or (delt is None and it_range is None):
            return
        n = computed_steps
        self.line.set_data((it_range[:n], E[:n]))
        self.ax.set_xlim(0, n)
        self.ax.set_ylim(np.nanmin(E[:n]), np.nanmax(E[:n]))
        self.ax.grid(True)
        self.ax.set_ylabel('Energy E [kJ]')
        if delt is None:
            self.ax.set_xlabel('')
            return
        self.delt_line.set_data((it_range[:n], delt[:n]))
        self.twin.get_yaxis().set_visible(True)
        self.twin.set_xlabel('Step')
        self.twin.set_ylabel('delt (gray)')
        self.twin.set_xlim(0, n)
        dmin, dmax = np.nanmin(delt[:n]), np.nanmax(delt[:n])
        if dmax - dmin > 1e-20:
            self.twin.set_ylim(dmin, dmax)


class PhaseAreaTrace(Panel):
    """Low-silica / silica-rich area fractions vs t^(1/3), with the
    separation-time marker."""

    def build(self, ax):
        super().build(ax)
        self.low, = ax.plot([], [])
        self.high, = ax.plot([], [])
        ax.set_ylim(0.0, 1.0)
        self.legend = None
        self.marker = None
        self.blit_artists = (self.low, self.high)

    def update(self, domtime=None, SA=None, title='', computed_steps=0,
               x2=1.0, t0=0.0):
        if SA is None or domtime is None:
            return
        n = computed_steps
        self.low.set_data((domtime[1:n], SA[1:n]))
        self.high.set_data((domtime[1:n], 1 - SA[1:n]))
        self.low.set_label('low-silica')
        self.high.set_label('silica-rich')
        if self.legend is not None:
            self.legend.remove()
        self.legend = self.ax.legend()
        self.ax.set_xlim(0, x2)
        if t0 > 0:
            if self.marker is not None:
                self.marker.remove()
            self.marker = self.ax.axvline(t0 ** (1 / 3), color='black')
        self.ax.set_title(title)
        self.ax.grid(True)
        self.ax.set_xlabel('Time ** 1/3')
        self.ax.set_ylabel('Concentration Ratio')


class SurfaceEnergyTrace(Panel):
    """Surface energy E2 per step with the tau0 separation marker."""

    def build(self, ax):
        super().build(ax)
        self.line, = ax.plot([], [])
        self.marker = None
        self.label = None
        self.blit_artists = (self.line,)

    def update(self, E2=None, it_range=None, title='', computed_steps=0,
               tau0=0.0, t0=0.0):
        self.ax.set_title(title)
        if E2 is None:
            return
        n = computed_steps
        lo, hi = np.nanmin(E2[:n]), np.nanmax(E2[:n])
        self.line.set_data((it_range[:n], E2[:n]))
        self.ax.set_xlim(0, n)
        self.ax.set_ylim(lo, 1.25 * hi)
        if self.marker is not None:
            self.marker.remove()
        self.marker = self.ax.axvline(tau0, color='black')
        if self.label is not None:
            self.label.remove()
        self.label = self.ax.text(tau0 - 0.05 * n, 0.25 * hi,
                                  f"{t0:g} s @ {tau0} it", rotation=90)
        self.ax.set_xlabel('Step')
        self.ax.set_ylabel('Surface Energy E2 [kJ]')
        self.ax.grid(True)

    @property
    def extra_blit(self):
        return (self.label,) if self.label is not None else ()


class Histogram(Panel):
    """Concentration histogram of the full field."""

    def __init__(self, bins=15):
        self.bins = bins
        self.patches = None

    def update(self, U=None, title=''):
        if U is None:
            return
        self.ax.cla()
        vals = np.real(np.asarray(U)).ravel()
        try:
            import seaborn as sns
            self.patches = sns.histplot(
                data=vals, stat='probability', ax=self.ax,
                bins=self.bins).patches
        except ImportError:
            _, _, self.patches = self.ax.hist(
                vals, bins=self.bins,
                weights=np.full(vals.size, 1.0 / vals.size))
        self.ax.set_title(title)
        self.ax.set_xlabel('Concentration')

    @property
    def extra_blit(self):
        return tuple(self.patches) if self.patches else ()
