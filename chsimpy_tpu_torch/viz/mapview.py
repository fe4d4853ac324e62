"""Minimal single-axes U map (``--no-diagrams``; reference
``chsimpy/mapview.py``, ``chsimpy_tpu/viz/mapview.py``): a borderless
continuous-colormap image whose color limits track the field range,
window title carrying the run status."""

from __future__ import annotations

import numpy as np

from .. import sysinfo
from .base import BaseView
from .panels import Panel


class _BareMap(Panel):
    def build(self, ax):
        super().build(ax)
        self.image = ax.imshow(np.zeros((2, 2)), cmap='plasma',
                               aspect='equal', vmin=0.75, vmax=1.0)
        ax.axis('off')
        self.blit_artists = (self.image,)

    def update(self, U=None, title=''):
        from matplotlib import colors
        self.ax.set_title('')
        if U is None:
            return
        U = np.asarray(U)
        self.image.set_cmap(colors.LinearSegmentedColormap.from_list(
            'mylist', ['orange', 'yellow'], N=25))
        self.image.set_clim(vmin=np.min(U), vmax=np.max(U))
        self.image.set_data(np.real(U))


class MapView(BaseView):
    def __init__(self, N):
        super().__init__()
        self.N = N
        self.title = None
        self.fig, ax = self._plt.subplots(
            1, 1, figsize=(4, 4), layout=None,
            gridspec_kw={'wspace': 0., 'hspace': 0., 'top': 1, 'right': 1,
                         'bottom': 0., 'left': 0.},
            clear=True)
        self.map = _BareMap()
        self.map.build(ax)
        self.panels = [self.map]
        self._finish_init()

    def set_Umap(self, U, threshold, title):
        self.map.update(U=U)
        self.title = title

    def draw(self):
        super().draw()
        if not sysinfo.is_notebook() and self.title is not None:
            try:
                self.fig.canvas.manager.set_window_title(self.title)
            except Exception:
                pass
