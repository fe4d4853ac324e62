"""Shared view machinery: matplotlib setup, interactivity modes, generic
blitting over panel artists (``chsimpy_tpu/viz/base.py``).

matplotlib is imported when a view is built, never when this module is:
a run without a view (``--no-gui`` without ``--png``/``--png-anim``)
needs no matplotlib, and a run that asks for a view on a machine without
it fails with an error that says so (:func:`require_matplotlib`)."""

from __future__ import annotations

import time

from .. import sysinfo


MATPLOTLIB_MSG = ("the view (the GUI window, --png, --png-anim, the "
                  "experiment's --live-view and --png) needs matplotlib, "
                  "which is not installed: install it, or run with --no-gui "
                  "and without the PNG flags")


def require_matplotlib() -> None:
    """Raise ModuleNotFoundError naming matplotlib and --no-gui when it is
    not installed."""
    import importlib.util
    if importlib.util.find_spec('matplotlib') is None:
        raise ModuleNotFoundError(MATPLOTLIB_MSG, name='matplotlib')


def setup_matplotlib():
    require_matplotlib()
    import matplotlib
    if not sysinfo.is_notebook():
        try:
            import PyQt5  # noqa: F401  (faster GUI event loop when present)
            matplotlib.use('Qt5Agg')
        except ImportError:
            pass
    from matplotlib import pyplot as plt
    return plt


def pause_without_show(plt, interval):
    """Event-loop tick that does not raise the window."""
    manager = plt._pylab_helpers.Gcf.get_active()
    if manager is not None:
        canvas = manager.canvas
        if canvas.figure.stale:
            canvas.draw_idle()
        canvas.start_event_loop(interval)
    else:
        time.sleep(interval)


class BaseView:
    """Figure lifecycle + blitting common to both views.  Subclasses set
    ``self.fig`` and ``self.panels`` (list of built Panel objects)."""

    def __init__(self):
        self._plt = setup_matplotlib()
        self._blit = not sysinfo.is_notebook()
        self._backgrounds = None
        self.imode_defaulted = self._plt.isinteractive()
        self._plt.ioff()
        self.fig = None
        self.panels = []

    def _finish_init(self):
        if self.imode_defaulted:
            self._plt.ion()

    # -- interactivity ------------------------------------------------
    def imode_on(self):
        self._plt.ion()

    def imode_off(self):
        self._plt.ioff()

    def imode_default(self):
        self.imode_on() if self.imode_defaulted else self.imode_off()

    # -- blitting -----------------------------------------------------
    def _blit_axes(self):
        out = []
        for p in self.panels:
            out.append(p.ax)
            if hasattr(p, 'twin'):
                out.append(p.twin)
        return out

    def prepare(self, show=True):
        self._hide_axes(True)
        self.fig.canvas.draw()
        if self._blit:
            self._backgrounds = [
                self.fig.canvas.copy_from_bbox(ax.bbox)
                for ax in self._blit_axes()]
            if show:
                self._plt.show(block=False)

    def finish(self):
        self._hide_axes(False)

    def _hide_axes(self, hidden: bool):
        pass  # overridden where panels hide axes during live updates

    def draw(self):
        if self._blit and self._backgrounds:
            for bg in self._backgrounds:
                self.fig.canvas.restore_region(bg)
            for p in self.panels:
                for artist in p.blit_artists:
                    p.ax.draw_artist(artist)
                for artist in getattr(p, 'extra_blit', ()):
                    p.ax.draw_artist(artist)
            for ax in self._blit_axes():
                self.fig.canvas.blit(ax.bbox)
        else:
            if sysinfo.is_notebook():
                self.fig.canvas.draw()
            else:
                pause_without_show(self._plt, 0.001)
        self.fig.canvas.flush_events()

    def show(self, block=False):
        plt = self._plt
        if sysinfo.is_notebook():
            self.fig.canvas.toolbar_visible = False
            self.fig.canvas.header_visible = False
            if block:
                from IPython.display import display
                display(self.fig)
            else:
                plt.show(block=False)
        else:
            plt.show(block=block)
            pause_without_show(plt, 1e-6)

    def render_to(self, fname):
        self.fig.savefig(fname, pad_inches=0.5, dpi=100)

    def __del__(self):
        try:
            if not sysinfo.is_notebook():
                self._plt.close(self.fig)
        except Exception:
            pass
