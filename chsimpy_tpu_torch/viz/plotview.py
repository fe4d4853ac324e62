"""Six-panel diagnostics view (``chsimpy_tpu/viz/plotview.py``).

Same six diagnostics as the reference GUI (``chsimpy/plotview.py``):
U map, mid-row slice, total energy (+delt twin in adaptive mode), phase
areas vs t^(1/3), surface energy with the separation marker, and the
concentration histogram — composed from the Panel primitives in panels.py
with generic blitting (base.py).  The ``set_*`` methods keep the reference's
calling convention (used by Simulator._update_view)."""

from __future__ import annotations

from .base import BaseView
from .panels import (EnergyTrace, FieldMap, Histogram, MidRowSlice,
                     PhaseAreaTrace, SurfaceEnergyTrace)


class PlotView(BaseView):
    def __init__(self, N, XXX):
        super().__init__()
        self.N = N
        self.fig, axs = self._plt.subplots(
            3, 2, figsize=(10, 9), layout=None,
            gridspec_kw={'wspace': 0.3, 'hspace': 0.33, 'top': 0.95,
                         'right': 0.9, 'bottom': 0.075, 'left': 0.1},
            clear=True)
        self.umap = FieldMap()
        self.uline = MidRowSlice(N)
        self.energy = EnergyTrace()
        self.areas = PhaseAreaTrace()
        self.surface = SurfaceEnergyTrace()
        self.hist = Histogram()
        placement = [(self.umap, axs[0, 0]), (self.uline, axs[0, 1]),
                     (self.energy, axs[1, 0]), (self.areas, axs[1, 1]),
                     (self.surface, axs[2, 0]), (self.hist, axs[2, 1])]
        for panel, ax in placement:
            panel.build(ax)
        self.panels = [p for p, _ in placement]
        self._finish_init()

    # -- reference-compatible update API ------------------------------
    def set_Umap(self, U, threshold, title):
        self.umap.update(U=U, threshold=threshold, title=title)

    def set_Uline(self, U, title):
        self.uline.update(U=U, title=title)

    def set_Eline(self, E, it_range, title, computed_steps):
        self.energy.update(E=E, it_range=it_range, title=title,
                           computed_steps=computed_steps)

    def set_Eline_delt(self, E, it_range, delt, title, computed_steps):
        self.energy.update(E=E, it_range=it_range, title=title,
                           computed_steps=computed_steps, delt=delt)

    def set_SAlines(self, domtime, SA, title, computed_steps, x2, t0):
        self.areas.update(domtime=domtime, SA=SA, title=title,
                          computed_steps=computed_steps, x2=x2, t0=t0)

    def set_E2line(self, E2, it_range, title, computed_steps, tau0, t0):
        self.surface.update(E2=E2, it_range=it_range, title=title,
                            computed_steps=computed_steps, tau0=tau0, t0=t0)

    def set_Uhist(self, U, title):
        self.hist.update(U=U, title=title)

    # -- live-update axis handling ------------------------------------
    def _hide_axes(self, hidden: bool):
        visible = not hidden
        for ax in (self.surface.ax, self.energy.ax):
            ax.get_xaxis().set_visible(visible)
            ax.get_yaxis().set_visible(visible)
        self.energy.twin.get_yaxis().set_visible(visible)
        self.hist.ax.get_xaxis().set_visible(visible)
        self.hist.ax.get_yaxis().set_visible(visible)
        self.areas.ax.get_xaxis().set_visible(visible)
