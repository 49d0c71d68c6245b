"""Face-restoration helper: align faces to the FFHQ 5-landmark template,
crop, and paste restored faces back with a soft mask (mirrors
``refid_tpu/utils/face_util.py``; upstream
``basicsr/utils/face_util.py:16-217``).  No REFID path uses it.

The JAX helper's cv2 calls become torch ops on the CPU, with cv2's
conventions:

* :func:`warp_affine` (``cv2.warpAffine``): ``grid_sample`` in float64 at
  the inverse-mapped pixel centres (integer coordinates are pixel
  centres), bilinear, zeros outside the source;
* :func:`resize_bilinear` (``cv2.resize``, ``INTER_LINEAR``):
  ``interpolate`` with half-pixel centres, edges clamped;
* :func:`erode` (``cv2.erode`` with a k x k box of ones): a min-pool whose
  window starts ``k // 2`` before the pixel, the frame's outside ignored;
* :func:`gaussian_blur` (``cv2.GaussianBlur`` with sigma 0): cv2's
  kernel for the size (its fixed tables up to 9 taps) separably, with
  reflect-101 borders.

uint8 results are rounded to nearest, as cv2 saturates; cv2's fixed-point
interpolation (1/32-pixel positions, 11- and 15-bit weights) is not
copied, so uint8 results may differ from cv2's by a level or so on sharp
edges.  Images are read and written with the port's PNG codec.  dlib is
imported only by :meth:`FaceRestorationHelper.init_dlib`; the geometry
works without it (landmarks supplied directly).  Inverse affines save as
``.npy``.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from refid_tpu_torch.data.img_util import imread, imwrite

__all__ = ["estimate_similarity", "warp_affine", "resize_bilinear", "erode",
           "gaussian_blur", "FaceRestorationHelper"]

# cv2's getGaussianKernel tables for sigma <= 0 and sizes up to 9
_SMALL_GAUSSIAN = {1: [1.0], 3: [0.25, 0.5, 0.25],
                   5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
                   7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
                   9: [0.015625, 0.05078125, 0.1171875, 0.19921875, 0.234375, 0.19921875,
                       0.1171875, 0.05078125, 0.015625]}


def estimate_similarity(src, dst):
    """Least-squares similarity transform (Umeyama 1991): the 2x3 affine
    ``M`` with ``dst ~= src @ M[:, :2].T + M[:, 2]``."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    if src.shape != dst.shape or src.ndim != 2 or src.shape[1] != 2:
        raise ValueError(f"src {src.shape} and dst {dst.shape} must be equal (n, 2)")
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / src.shape[0]
    U, S, Vt = np.linalg.svd(cov)
    D = np.diag([1.0, np.sign(np.linalg.det(U) * np.linalg.det(Vt))])
    R = U @ D @ Vt
    scale = np.trace(np.diag(S) @ D) / ((sc ** 2).sum() / src.shape[0])
    M = np.empty((2, 3), np.float64)
    M[:, :2] = scale * R
    M[:, 2] = mu_d - scale * (R @ mu_s)
    return M


def _to_chw(img: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(img)).to(torch.float64)
    return (t[..., None] if t.dim() == 2 else t).permute(2, 0, 1)[None]


def _from_chw(t: torch.Tensor, like: np.ndarray) -> np.ndarray:
    out = t[0].permute(1, 2, 0)
    if like.ndim == 2:
        out = out[..., 0]
    if like.dtype == np.uint8:
        return out.round().clamp(0, 255).to(torch.uint8).numpy()
    return out.numpy().astype(like.dtype)


def warp_affine(img: np.ndarray, M, dsize) -> np.ndarray:
    """``cv2.warpAffine(img, M, dsize)``: ``dst(x, y) = src(M^-1 (x, y))``,
    bilinear, zeros outside; ``dsize`` is ``(width, height)``."""
    w_out, h_out = dsize
    h, w = img.shape[:2]
    A = np.vstack([np.asarray(M, np.float64), [0.0, 0.0, 1.0]])
    inv = torch.from_numpy(np.linalg.inv(A)[:2])
    ys, xs = torch.meshgrid(torch.arange(h_out, dtype=torch.float64),
                            torch.arange(w_out, dtype=torch.float64), indexing="ij")
    sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
    # align_corners=True: -1 and 1 are the centres of the first and last pixels
    grid = torch.stack([2 * sx / max(w - 1, 1) - 1, 2 * sy / max(h - 1, 1) - 1], -1)[None]
    out = F.grid_sample(_to_chw(img), grid, mode="bilinear", padding_mode="zeros",
                        align_corners=True)
    return _from_chw(out, img)


def resize_bilinear(img: np.ndarray, dsize) -> np.ndarray:
    """``cv2.resize(img, dsize)`` (``INTER_LINEAR``); ``dsize`` is ``(width,
    height)``."""
    w_out, h_out = dsize
    out = F.interpolate(_to_chw(img), size=(h_out, w_out), mode="bilinear",
                        align_corners=False)
    return _from_chw(out, img)


def erode(img: np.ndarray, k: int) -> np.ndarray:
    """``cv2.erode(img, np.ones((k, k)))``: the minimum over the k x k
    window from ``k // 2`` before the pixel to ``k - 1 - k // 2`` after."""
    a, b = k // 2, k - 1 - k // 2
    x = F.pad(_to_chw(img), (a, b, a, b), value=math.inf)
    return _from_chw(-F.max_pool2d(-x, k, 1), img)


def _gaussian_kernel(ksize: int) -> torch.Tensor:
    if ksize in _SMALL_GAUSSIAN:
        return torch.tensor(_SMALL_GAUSSIAN[ksize], dtype=torch.float64)
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = torch.arange(ksize, dtype=torch.float64) - (ksize - 1) / 2
    g = torch.exp(-x * x / (2 * sigma * sigma))
    return g / g.sum()


def gaussian_blur(img: np.ndarray, ksize: int) -> np.ndarray:
    """``cv2.GaussianBlur(img, (ksize, ksize), 0)`` for an odd ``ksize``."""
    if ksize % 2 != 1:
        raise ValueError(f"ksize must be odd, got {ksize}")
    g = _gaussian_kernel(ksize)
    x = _to_chw(img)
    c, r = x.shape[1], ksize // 2
    x = F.pad(x, (r, r, r, r), mode="reflect")          # reflect-101
    x = F.conv2d(x, g.view(1, 1, 1, -1).expand(c, 1, 1, ksize), groups=c)
    x = F.conv2d(x, g.view(1, 1, -1, 1).expand(c, 1, ksize, 1), groups=c)
    return _from_chw(x, img)


class FaceRestorationHelper:
    """Upstream's workflow: detect (dlib, optional) -> 5-landmark similarity
    alignment to the FFHQ template -> crop -> restore (the caller) ->
    inverse warp and soft-mask paste."""

    def __init__(self, upscale_factor, face_size=512):
        self.upscale_factor = upscale_factor
        self.face_size = (face_size, face_size)
        # the 5 landmarks of FFHQ faces at 1024x1024, scaled to face_size
        self.face_template = np.array(
            [[686.77227723, 488.62376238],
             [586.77227723, 493.59405941],
             [337.91089109, 488.38613861],
             [437.95049505, 493.51485149],
             [513.58415842, 678.5049505]]) / (1024 // face_size)
        self.save_png = True
        self.input_img = None
        self.clean_all()

    # -- detection (dlib-gated) -----------------------------------------
    def init_dlib(self, detection_path, landmark5_path, landmark68_path):
        try:
            import dlib
        except ImportError as e:
            raise ImportError(
                "FaceRestorationHelper detection needs dlib, which is not "
                "installed; the alignment and paste geometry works without it "
                "(supply landmarks directly)") from e
        self.face_detector = dlib.cnn_face_detection_model_v1(detection_path)
        self.shape_predictor_5 = dlib.shape_predictor(landmark5_path)
        self.shape_predictor_68 = dlib.shape_predictor(landmark68_path)

    def read_input_image(self, img_path):
        """The PNG as uint8 RGB (upstream reads with cv2 and converts)."""
        self.input_img = imread(str(img_path), float32=False, rgb=True)

    def detect_faces(self, img_path, upsample_num_times=1):
        """dlib CNN detection and 5-point landmarks."""
        if not hasattr(self, "face_detector"):
            raise RuntimeError("call init_dlib() first")
        self.read_input_image(img_path)
        det_faces = self.face_detector(self.input_img, upsample_num_times)
        for det in det_faces:
            shape = self.shape_predictor_5(self.input_img, det.rect)
            self.all_landmarks_5.append(np.array([[p.x, p.y] for p in shape.parts()]))
        return len(det_faces)

    # -- geometry --------------------------------------------------------
    def warp_crop_faces(self, save_cropped_path=None, save_inverse_affine_path=None):
        """The affine of each face from its 5 landmarks, the face_size crop,
        and the inverse affine at the upscaled resolution."""
        for idx, landmark in enumerate(self.all_landmarks_5):
            affine = estimate_similarity(landmark, self.face_template)
            self.affine_matrices.append(affine)
            self.cropped_faces.append(warp_affine(self.input_img, affine, self.face_size))
            if save_cropped_path is not None:
                path, ext = os.path.splitext(str(save_cropped_path))
                ext = ".png" if self.save_png else ext
                imwrite(self.cropped_faces[-1][..., ::-1], f"{path}_{idx:02d}{ext}")
            inverse = estimate_similarity(self.face_template, landmark * self.upscale_factor)
            self.inverse_affine_matrices.append(inverse)
            if save_inverse_affine_path is not None:
                path, _ = os.path.splitext(str(save_inverse_affine_path))
                np.save(f"{path}_{idx:02d}.npy", inverse)

    def add_restored_face(self, face):
        self.restored_faces.append(face)

    def paste_faces_to_input_image(self, save_path=None, upsample_img=None):
        """Inverse-warp each restored face (uint8 BGR) onto the upscaled input
        and blend with an eroded, blurred mask.  Returns the uint8 BGR
        composite; writes it (PNG) if ``save_path``."""
        input_img = np.ascontiguousarray(self.input_img[..., ::-1])
        h, w, _ = input_img.shape
        h_up, w_up = h * self.upscale_factor, w * self.upscale_factor
        if upsample_img is None:
            upsample_img = resize_bilinear(input_img, (w_up, h_up))
        upsample_img = upsample_img.astype(np.float32)
        if len(self.restored_faces) != len(self.inverse_affine_matrices):
            raise ValueError(f"{len(self.restored_faces)} restored faces for "
                             f"{len(self.inverse_affine_matrices)} aligned ones")
        for face, inverse in zip(self.restored_faces, self.inverse_affine_matrices):
            inv_restored = warp_affine(face, inverse, (w_up, h_up))
            mask = np.ones((*self.face_size, 3), np.float32)
            inv_mask = warp_affine(mask, inverse, (w_up, h_up))
            inv_mask_erosion = erode(inv_mask, 2 * self.upscale_factor)
            inv_face = inv_mask_erosion * inv_restored
            total_face_area = np.sum(inv_mask_erosion) // 3
            w_edge = int(total_face_area ** 0.5) // 20
            if w_edge > 0:
                r = w_edge * 2
                inv_soft_mask = gaussian_blur(erode(inv_mask_erosion, r), r + 1)
            else:
                inv_soft_mask = inv_mask_erosion
            upsample_img = inv_soft_mask * inv_face + (1 - inv_soft_mask) * upsample_img
        out = upsample_img.astype(np.uint8)
        if save_path is not None:
            save_path = str(save_path)
            if self.save_png:
                save_path = save_path.replace(".jpg", ".png").replace(".jpeg", ".png")
            imwrite(out, save_path)
        return out

    def clean_all(self):
        self.all_landmarks_5 = []
        self.all_landmarks_68 = []
        self.restored_faces = []
        self.affine_matrices = []
        self.cropped_faces = []
        self.inverse_affine_matrices = []
