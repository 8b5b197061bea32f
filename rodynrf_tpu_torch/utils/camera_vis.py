"""Camera-pose wireframe visualization for TensorBoard (port of
rodynrf_tpu/utils/camera_vis.py).

Numpy/matplotlib equivalent of the reference's 3D camera plot (reference:
train.py:771-794 get_camera_mesh/merge_wireframes, train.py:2365-2415 figure
assembly, train.py:121-151 set_axes_equal): each camera is drawn as a small
frustum pyramid; optimized cameras in orange (C1), GT in blue (C0), with red
segments joining matched centers.
"""

from __future__ import annotations

import numpy as np

# frustum template in camera space: 4 image-plane corners at unit depth + apex
_FRUSTUM = np.array(
    [[-0.5, -0.5, 1], [0.5, -0.5, 1], [0.5, 0.5, 1], [-0.5, 0.5, 1], [0, 0, 0]],
    np.float32,
)
# closed path visiting the pyramid's edges (10 vertices per camera)
_PATH = [0, 1, 2, 3, 0, 4, 1, 2, 4, 3]


def camera_wireframes(poses: np.ndarray, depth: float = 0.005):
    """[N, 3, 4] c2w -> (centers [N, 3], wire [N, 10, 3]) in world space."""
    poses = np.asarray(poses, np.float32)
    verts = _FRUSTUM[None] * depth @ np.swapaxes(poses[:, :3, :3], 1, 2)
    verts = verts + poses[:, None, :3, 3]
    return verts[:, 4], verts[:, _PATH]


def _set_axes_equal(ax):
    lims = np.array([ax.get_xlim3d(), ax.get_ylim3d(), ax.get_zlim3d()])
    centers = lims.mean(1)
    radius = 0.5 * np.abs(lims[:, 1] - lims[:, 0]).max()
    ax.set_xlim3d(centers[0] - radius, centers[0] + radius)
    ax.set_ylim3d(centers[1] - radius, centers[1] + radius)
    ax.set_zlim3d(centers[2] - radius, centers[2] + radius)


def camera_pose_figure(
    poses_aligned: np.ndarray, poses_gt: np.ndarray | None = None, depth: float = 0.005
) -> np.ndarray:
    """Render the camera-pose comparison plot to an RGB uint8 image [H, W, 3].

    Requires matplotlib (Agg); raises ImportError if absent — callers log the
    figure only when available.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")

    def draw(poses, color):
        centers, wires = camera_wireframes(poses, depth)
        ax.scatter(centers[:, 0], centers[:, 1], centers[:, 2], marker="o", color=color)
        for w in wires:
            ax.plot(w[:, 0], w[:, 1], w[:, 2], color=color)
        return centers

    center_gt = draw(poses_gt, "C0") if poses_gt is not None else None
    center = draw(poses_aligned, "C1")
    if center_gt is not None:
        for a, b in zip(center_gt, center):
            ax.plot([a[0], b[0]], [a[1], b[1]], [a[2], b[2]], color="red")

    _set_axes_equal(ax)
    fig.tight_layout()
    fig.canvas.draw()
    img = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return img
