"""Live visualization: animated closed-loop replay (modes 1 and 2) + GIF.

Equivalent of the reference's live-viz stack (Utils/MPC_sim_utils.py:268-487,
Logging_Plotting.py:81-118,193-229):

  * mode 1 — x/y track view with vehicle footprint, reference window and a
    trailing path,
  * mode 2 — track view + velocity trace + lateral-deviation trace + gg
    scatter diagram,
  * optional GIF export via imageio.

Two operating modes:

  * **Replay** (`animate(...)`): the whole run executes on-device first,
    then the logged arrays are animated at any frame-skip — same figures
    without throttling the control loop (the reference warns that GIF
    generation slows the simulation; here it cannot).
  * **During-sim** (`LiveView`): true live rendering while the loop runs,
    as the reference does (Logging_Plotting.py:193-229). The port's
    main.py sizes its chunks to `live_plot_freq` steps and hands the logs
    accumulated so far to a render thread at every chunk boundary, which
    calls `LiveView.update` while the main thread runs the *next* chunk.

Use `show=True` for an interactive session or `gif_path=` for headless
export; both work in either mode. Port of tum_control_tpu/eval/live_viz.py:
numpy logs in (`eval/logger.py::assemble_logs`), so rendering makes no
device call; matplotlib and imageio are imported when a view is made and
raise ImportError where they are not installed.
"""
from __future__ import annotations

import numpy as np

from tum_control_tpu_torch.eval.plots import pyplot


def _imageio():
    try:
        import imageio
    except ImportError as exc:
        raise ImportError("GIF export needs imageio, which is not installed") from exc
    return imageio


def _car_outline(x, y, yaw, length, width):
    """Vehicle footprint polygon (gen_car_shape analog, MPC_sim_utils.py:249-265)."""
    c, s = np.cos(yaw), np.sin(yaw)
    dx = np.array([length / 2, length / 2, -length / 2, -length / 2, length / 2])
    dy = np.array([width / 2, -width / 2, -width / 2, width / 2, width / 2])
    return x + c * dx - s * dy, y + s * dx + c * dy


def _setup_axes(plt, mode):
    """Figure + axes layout shared by replay and during-sim rendering."""
    if mode == 1:
        fig, ax_xy = plt.subplots(figsize=(9, 9))
        extra = {}
    else:
        fig = plt.figure(figsize=(15, 8))
        ax_xy = fig.add_subplot(2, 2, (1, 3))
        extra = {
            "vel": fig.add_subplot(2, 4, 3),
            "dev": fig.add_subplot(2, 4, 4),
            "gg": fig.add_subplot(2, 4, (7, 8)),
        }
    return fig, ax_xy, extra


def _window_limits(x, y, yaw, xwidth, ywidth):
    """Heading-dependent asymmetric view limits (MPC_sim_utils.py:365-382):
    most of the window lies ahead of the vehicle, quadrant-selected by yaw."""
    yaw = np.mod(yaw, 2 * np.pi)
    ahead_x = 0 <= yaw < np.pi / 2 or 3 * np.pi / 2 <= yaw
    ahead_y = yaw < np.pi
    xlim = (x - 0.2 * xwidth, x + 1.0 * xwidth) if ahead_x else (x - 1.0 * xwidth, x + 0.2 * xwidth)
    ylim = (y - 0.2 * ywidth, y + 1.0 * ywidth) if ahead_y else (y - 1.0 * ywidth, y + 0.2 * ywidth)
    return xlim, ylim


def _draw_frame(ax_xy, extra, logs, i, track, veh_length, veh_width, window, mode):
    """Render frame i of (possibly partial) logs onto the shared axes.
    `window` is (xwidth, ywidth) — separate extents as in the reference
    (sim_main_params.yaml live-viz keys; MPC_sim_utils.py:285-286)."""
    CiLX, REF, t = logs["CiLX"], logs["simREF"], logs["t"]
    xwidth, ywidth = window
    ax_xy.clear()
    if track is not None:
        ax_xy.plot(track.center[:, 0], track.center[:, 1], "k--", lw=0.5)
        ax_xy.plot(track.inner[:, 0], track.inner[:, 1], "k", lw=0.8)
        ax_xy.plot(track.outer[:, 0], track.outer[:, 1], "k", lw=0.8)
    ax_xy.plot(CiLX[: i + 1, 0], CiLX[: i + 1, 1], "b", lw=1.0)
    cx, cy = _car_outline(CiLX[i, 0], CiLX[i, 1], CiLX[i, 2], veh_length, veh_width)
    ax_xy.plot(cx, cy, "r")
    xlim, ylim = _window_limits(CiLX[i, 0], CiLX[i, 1], CiLX[i, 2], xwidth, ywidth)
    ax_xy.set_xlim(*xlim)
    ax_xy.set_ylim(*ylim)
    ax_xy.set_title(f"t = {t[i-1]:.2f} s   v = {CiLX[i,3]:.1f} m/s")
    ax_xy.set_aspect("equal")

    if mode == 2:
        extra["vel"].clear()
        extra["vel"].plot(t[:i], REF[:i, 3], "k--", lw=0.8)
        extra["vel"].plot(t[:i], CiLX[1 : i + 1, 3], "b", lw=0.8)
        extra["vel"].set_title("velocity [m/s]")
        extra["dev"].clear()
        extra["dev"].plot(t[:i], logs["dev_lat"][:i], "b", lw=0.8)
        extra["dev"].set_title("lateral deviation [m]")
        extra["gg"].clear()
        alat = logs["a_lat"][1 : i + 1]
        alon = logs["MPC_SimX"][1 : i + 1, 7]
        extra["gg"].scatter(alat, alon, s=2, c=t[:i], cmap="viridis")
        extra["gg"].set_xlabel("a_lat [m/s2]")
        extra["gg"].set_ylabel("a_lon [m/s2]")
        extra["gg"].set_xlim(-8, 8)
        extra["gg"].set_ylim(-5, 4)


class LiveView:
    """True during-sim visualization (reference Logging_Plotting.py:193-229).

    Created before the closed loop starts; `update(partial_logs, i)` is
    called at chunk boundaries with the logs accumulated so far and renders
    the latest state (interactive window if `show`, GIF frame if
    `gif_path`). `finish()` writes the GIF and closes the figure.
    """

    def __init__(self, track=None, mode=2, veh_length=4.973, veh_width=1.941,
                 window=(100.0, 100.0), gif_path=None, show=False):
        plt = pyplot(show)
        if gif_path is not None:
            _imageio()

        self._plt = plt
        self._track = track
        self._mode = mode
        if not isinstance(window, (tuple, list)):
            window = (float(window), float(window))
        self._dims = (veh_length, veh_width, tuple(window))
        self._gif_path = gif_path
        self._show = show
        self._images = []
        self.fig, self._ax_xy, self._extra = _setup_axes(plt, mode)
        if show:
            plt.ion()
            self.fig.show()

    def update(self, logs: dict, i: int):
        l, w, win = self._dims
        _draw_frame(self._ax_xy, self._extra, logs, i, self._track, l, w, win, self._mode)
        if self._gif_path is not None:
            self.fig.canvas.draw()
            buf = np.asarray(self.fig.canvas.buffer_rgba())[..., :3]
            self._images.append(buf.copy())
        if self._show:
            self._plt.pause(1e-5)

    def finish(self) -> int:
        n = len(self._images)
        if self._gif_path is not None and self._images:
            _imageio().mimsave(self._gif_path, self._images, duration=100, loop=0)
        if not self._show:
            self._plt.close(self.fig)
        return n


def animate(
    logs: dict,
    track=None,
    mode: int = 2,
    frame_skip: int = 10,
    veh_length: float = 4.973,
    veh_width: float = 1.941,
    window=(100.0, 100.0),
    gif_path: str = None,
    show: bool = False,
    gg_table=None,
):
    plt = pyplot(show)
    if gif_path is not None:
        _imageio()
    if not isinstance(window, (tuple, list)):
        window = (float(window), float(window))
    window = tuple(window)
    n = logs["simREF"].shape[0]
    frames = range(1, n, frame_skip)

    fig, ax_xy, extra = _setup_axes(plt, mode)
    images = []
    for i in frames:
        _draw_frame(ax_xy, extra, logs, i, track, veh_length, veh_width, window, mode)
        if gif_path is not None:
            fig.canvas.draw()
            buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
            images.append(buf.copy())
        if show:
            plt.pause(1e-5)

    if gif_path is not None and images:
        _imageio().mimsave(gif_path, images, duration=100, loop=0)
    if not show:
        plt.close(fig)
    return len(images)
