"""Stereo datasets for evaluation (the port's copy of the unaugmented half
of ``raft_stereo_tpu/data/datasets.py``).

Samples are numpy NHWC dicts (``image1``, ``image2``, ``flow``, ``valid``,
``paths``), equal to the JAX package's ``sample(i)`` on the same tree:

* ``dataset * k`` replicates the index list and ``a + b`` concatenates,
  each item decoded by its own dataset;
* the directory layouts are the reference's, so existing dataset downloads
  work unchanged.

Augmentation (the training half: ``aug_params``, the loader) is not ported
yet (ROADMAP A10b): passing ``aug_params`` raises.
"""

from __future__ import annotations

import copy
import logging
import os.path as osp
from glob import glob
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from raft_stereo_tpu_torch.data import frame_utils

logger = logging.getLogger(__name__)

MAX_FLOW_VALID = 512.0  # dense-GT validity threshold


class StereoDataset:
    """Base dataset: path lists + decode -> numpy NHWC sample dict."""

    def __init__(self, aug_params: Optional[dict] = None, sparse: bool = False,
                 reader=None):
        if aug_params is not None:
            raise ValueError("aug_params: augmentation is not ported yet "
                             "(ROADMAP A10b); the port's datasets give "
                             "unaugmented frames")
        self.sparse = sparse
        self.disparity_reader = reader or frame_utils.read_disp_pfm
        self.image_list: List[List[str]] = []
        self.disparity_list: List[str] = []
        self.extra_info: List = []

    # -- composition ------------------------------------------------------
    def __mul__(self, k: int) -> "StereoDataset":
        out = copy.copy(self)
        out.image_list = k * self.image_list
        out.disparity_list = k * self.disparity_list
        out.extra_info = k * self.extra_info
        delegates = getattr(self, "_delegates", None)
        if delegates is not None:
            out._delegates = k * delegates
        return out

    __rmul__ = __mul__

    def __add__(self, other: "StereoDataset") -> "StereoDataset":
        out = StereoDataset.__new__(StereoDataset)
        StereoDataset.__init__(out)
        out.image_list = self.image_list + other.image_list
        out.disparity_list = self.disparity_list + other.disparity_list
        out.extra_info = self.extra_info + other.extra_info
        # per-item decode settings must travel with each item
        out._delegates = (getattr(self, "_delegates", None)
                          or [self] * len(self.image_list)) + \
                         (getattr(other, "_delegates", None)
                          or [other] * len(other.image_list))
        return out

    def __len__(self) -> int:
        return len(self.image_list)

    # -- decode -----------------------------------------------------------
    def _source(self, index: int) -> "StereoDataset":
        owner = getattr(self, "_delegates", None)
        return owner[index] if owner is not None else self

    def read_raw(self, index: int):
        """Decode one (img1, img2, flow, valid) tuple."""
        disp = self._source(index).disparity_reader(
            self.disparity_list[index])
        if isinstance(disp, tuple):
            disp, valid = disp
        else:
            valid = disp < MAX_FLOW_VALID

        img1 = frame_utils.read_image(self.image_list[index][0])
        img2 = frame_utils.read_image(self.image_list[index][1])

        img1 = np.asarray(img1).astype(np.uint8)
        img2 = np.asarray(img2).astype(np.uint8)
        if img1.ndim == 2:  # grayscale -> 3-channel
            img1 = np.tile(img1[..., None], (1, 1, 3))
            img2 = np.tile(img2[..., None], (1, 1, 3))
        else:
            img1 = img1[..., :3]
            img2 = img2[..., :3]

        disp = np.asarray(disp, np.float32)
        # disparity -> horizontal flow; left image content moves left
        flow = np.stack([-disp, np.zeros_like(disp)], axis=-1)
        return img1, img2, flow, np.asarray(valid)

    def sample(self, index: int) -> Dict[str, np.ndarray]:
        """One frame as NHWC arrays (uint8 images, float32 flow-x and
        valid)."""
        index = index % len(self.image_list)
        img1, img2, flow, valid = self.read_raw(index)
        if not self._source(index).sparse:
            valid = (np.abs(flow[..., 0]) < MAX_FLOW_VALID) & \
                    (np.abs(flow[..., 1]) < MAX_FLOW_VALID)
        return {
            "image1": np.ascontiguousarray(img1, dtype=np.uint8),
            "image2": np.ascontiguousarray(img2, dtype=np.uint8),
            "flow": flow[..., :1].astype(np.float32),
            "valid": valid.astype(np.float32),
            "paths": tuple(self.image_list[index])
            + (self.disparity_list[index],),
        }


# ------------------------------------------------------------------ datasets

class SceneFlow(StereoDataset):
    """FlyingThings3D + Monkaa + Driving (stereo_datasets.py:123-184)."""

    def __init__(self, aug_params=None, root="datasets",
                 dstype="frames_cleanpass", things_test=False):
        super().__init__(aug_params)
        self.root = root
        self.dstype = dstype
        if things_test:
            self._add_things("TEST")
        else:
            self._add_things("TRAIN")
            self._add_monkaa()
            self._add_driving()

    def _append(self, left_images: Sequence[str], disp_from):
        for im in left_images:
            self.image_list.append([im, im.replace("left", "right")])
            self.disparity_list.append(disp_from(im))

    def _add_things(self, split="TRAIN"):
        n0 = len(self.disparity_list)
        root = osp.join(self.root, "FlyingThings3D")
        left = sorted(glob(osp.join(root, self.dstype, split, "*/*/left/*.png")))
        # the reference's fixed 400-frame val split, seed 1000
        # (stereo_datasets.py:145-149)
        val_idxs = set(
            np.random.RandomState(1000).permutation(len(left))[:400])
        keep = [im for i, im in enumerate(left)
                if split == "TRAIN" or i in val_idxs]
        self._append(keep, lambda im: im.replace(self.dstype, "disparity")
                     .replace(".png", ".pfm"))
        logger.info("Added %d from FlyingThings %s",
                    len(self.disparity_list) - n0, self.dstype)

    def _add_monkaa(self):
        n0 = len(self.disparity_list)
        root = osp.join(self.root, "Monkaa")
        left = sorted(glob(osp.join(root, self.dstype, "*/left/*.png")))
        self._append(left, lambda im: im.replace(self.dstype, "disparity")
                     .replace(".png", ".pfm"))
        logger.info("Added %d from Monkaa", len(self.disparity_list) - n0)

    def _add_driving(self):
        n0 = len(self.disparity_list)
        root = osp.join(self.root, "Driving")
        left = sorted(glob(osp.join(root, self.dstype, "*/*/*/left/*.png")))
        self._append(left, lambda im: im.replace(self.dstype, "disparity")
                     .replace(".png", ".pfm"))
        logger.info("Added %d from Driving", len(self.disparity_list) - n0)


class ETH3D(StereoDataset):
    def __init__(self, aug_params=None, root="datasets/ETH3D", split="training"):
        # The reference ETH3D (stereo_datasets.py:187-189) reads disp0GT.pfm
        # through plain read_gen, so ``valid`` is ``disp < 512`` — the nocc
        # mask on disk is never read. (The Middlebury nocc reader here would
        # silently change the validator's mask semantics; oracle-pinned in
        # tests/test_eval_oracle.py.)
        super().__init__(aug_params, sparse=True,
                         reader=frame_utils.read_disp_eth3d)
        im0 = sorted(glob(osp.join(root, f"two_view_{split}/*/im0.png")))
        im1 = sorted(glob(osp.join(root, f"two_view_{split}/*/im1.png")))
        if split == "training":
            disp = sorted(glob(osp.join(root, "two_view_training_gt/*/disp0GT.pfm")))
        else:  # test split has no GT; reference points at a placeholder
            disp = [osp.join(root, "two_view_training_gt/playground_1l/disp0GT.pfm")] * len(im0)
        for i0, i1, d in zip(im0, im1, disp):
            self.image_list.append([i0, i1])
            self.disparity_list.append(d)


class SintelStereo(StereoDataset):
    def __init__(self, aug_params=None, root="datasets/SintelStereo"):
        super().__init__(aug_params, sparse=True,
                         reader=frame_utils.read_disp_sintel)
        im0 = sorted(glob(osp.join(root, "training/*_left/*/frame_*.png")))
        im1 = sorted(glob(osp.join(root, "training/*_right/*/frame_*.png")))
        disp = sorted(glob(osp.join(root, "training/disparities/*/frame_*.png"))) * 2
        for i0, i1, d in zip(im0, im1, disp):
            if i0.split("/")[-2:] != d.split("/")[-2:]:
                raise ValueError(f"Sintel pairing mismatch: {i0} vs {d}")
            self.image_list.append([i0, i1])
            self.disparity_list.append(d)


class FallingThings(StereoDataset):
    def __init__(self, aug_params=None, root="datasets/FallingThings"):
        super().__init__(aug_params, reader=frame_utils.read_disp_falling_things)
        with open(osp.join(root, "filenames.txt")) as f:
            filenames = sorted(f.read().splitlines())
        for e in filenames:
            self.image_list.append([osp.join(root, e),
                                    osp.join(root, e.replace("left.jpg", "right.jpg"))])
            self.disparity_list.append(
                osp.join(root, e.replace("left.jpg", "left.depth.png")))


class TartanAir(StereoDataset):
    def __init__(self, aug_params=None, root="datasets", keywords=()):
        super().__init__(aug_params, reader=frame_utils.read_disp_tartanair)
        with open(osp.join(root, "tartanair_filenames.txt")) as f:
            filenames = sorted(
                s for s in f.read().splitlines()
                if "seasonsforest_winter/Easy" not in s)
        for kw in keywords:
            filenames = [s for s in filenames if kw in s.lower()]
        for e in filenames:
            self.image_list.append([osp.join(root, e),
                                    osp.join(root, e.replace("_left", "_right"))])
            self.disparity_list.append(
                osp.join(root, e.replace("image_left", "depth_left")
                         .replace("left.png", "left_depth.npy")))


class KITTI(StereoDataset):
    def __init__(self, aug_params=None, root="datasets/KITTI",
                 image_set="training", split=None):
        super().__init__(aug_params, sparse=True,
                         reader=frame_utils.read_disp_kitti)
        if split is not None:  # accept fetch_dataloader's spelling
            image_set = "training" if "kitti" in str(split) else str(split)
        im0 = sorted(glob(osp.join(root, image_set, "image_2/*_10.png")))
        im1 = sorted(glob(osp.join(root, image_set, "image_3/*_10.png")))
        if image_set == "training":
            disp = sorted(glob(osp.join(root, "training", "disp_occ_0/*_10.png")))
        else:
            disp = [osp.join(root, "training/disp_occ_0/000085_10.png")] * len(im0)
        for i0, i1, d in zip(im0, im1, disp):
            self.image_list.append([i0, i1])
            self.disparity_list.append(d)


class Middlebury(StereoDataset):
    def __init__(self, aug_params=None, root="datasets/Middlebury", split="F"):
        super().__init__(aug_params, sparse=True,
                         reader=frame_utils.read_disp_middlebury)
        if split not in ("F", "H", "Q", "2014"):
            raise ValueError(f"bad Middlebury split {split!r}")
        if split == "2014":
            for scene in sorted((Path(root) / "2014").glob("*")):
                for s in ("E", "L", ""):
                    self.image_list.append([str(scene / "im0.png"),
                                            str(scene / f"im1{s}.png")])
                    self.disparity_list.append(str(scene / "disp0.pfm"))
        else:
            official = Path(root, "MiddEval3/official_train.txt") \
                .read_text().splitlines()
            names = [osp.basename(p)
                     for p in glob(osp.join(root, "MiddEval3/trainingF/*"))]
            names = sorted(n for n in names if n in official)
            for name in names:
                base = osp.join(root, "MiddEval3", f"training{split}", name)
                self.image_list.append([osp.join(base, "im0.png"),
                                        osp.join(base, "im1.png")])
                self.disparity_list.append(osp.join(base, "disp0GT.pfm"))
