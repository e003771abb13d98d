"""Stereo datasets (the port's copy of ``raft_stereo_tpu/data/datasets.py``).

Samples are numpy NHWC dicts (``image1``, ``image2``, ``flow``, ``valid``,
``paths``), equal to the JAX package's ``sample(i, rng)`` on the same tree
and generator:

* ``sample(index, rng)`` takes an explicit ``np.random.Generator`` for the
  augmentor; without one an augmented dataset keys a Philox generator by
  the index, so an ad-hoc call is reproducible; the evaluation stream
  calls ``sample(index)`` on unaugmented datasets;
* ``dataset * k`` replicates the index list and ``a + b`` concatenates,
  each item decoded and augmented by its own dataset;
* the directory layouts are the reference's, so existing dataset downloads
  work unchanged;
* :func:`build_train_dataset` mixes datasets with the reference's
  oversampling ratios and :func:`fetch_dataloader` builds the training
  loader from a ``TrainConfig``.
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
from raft_stereo_tpu_torch.data.augment import (FlowAugmentor,
                                                SparseFlowAugmentor)

logger = logging.getLogger(__name__)

MAX_FLOW_VALID = 512.0  # dense-GT validity threshold


def _make_augmentor(aug_params: Optional[dict], sparse: bool):
    if aug_params is None or "crop_size" not in aug_params:
        return None
    params = dict(aug_params)
    params.pop("img_pad", None)
    cls = SparseFlowAugmentor if sparse else FlowAugmentor
    return cls(**params)


class StereoDataset:
    """Base dataset: path lists + decode + augment -> numpy NHWC sample
    dict."""

    def __init__(self, aug_params: Optional[dict] = None, sparse: bool = False,
                 reader=None):
        self.sparse = sparse
        self.img_pad = (aug_params or {}).get("img_pad")
        self.augmentor = _make_augmentor(aug_params, sparse)
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
        # per-item decode/augment settings must travel with each item
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

    def sample(self, index: int, rng: Optional[np.random.Generator] = None
               ) -> Dict[str, np.ndarray]:
        """One frame as NHWC arrays (uint8 images, float32 flow-x and
        valid), augmented with ``rng`` where the dataset has an
        augmentor."""
        index = index % len(self.image_list)
        img1, img2, flow, valid = self.read_raw(index)

        src = self._source(index)
        if src.augmentor is not None:
            if rng is None:
                # keyed by the index: an ad-hoc call is reproducible too
                rng = np.random.default_rng(np.random.Philox(key=index))
            if src.sparse:
                img1, img2, flow, valid = src.augmentor(img1, img2, flow,
                                                        valid, rng)
            else:
                img1, img2, flow = src.augmentor(img1, img2, flow, rng)

        if not src.sparse:
            valid = (np.abs(flow[..., 0]) < MAX_FLOW_VALID) & \
                    (np.abs(flow[..., 1]) < MAX_FLOW_VALID)

        if src.img_pad is not None:
            pad_h, pad_w = src.img_pad
            pad = [(pad_h, pad_h), (pad_w, pad_w), (0, 0)]
            img1 = np.pad(img1, pad)
            img2 = np.pad(img2, pad)

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


# ------------------------------------------------------------------ loader entry

def build_train_dataset(train_datasets: Sequence[str], aug_params: dict,
                        root: str = "datasets") -> StereoDataset:
    """Mix datasets with the reference's oversampling ratios."""
    combined = None
    for name in train_datasets:
        if name.startswith("middlebury_"):
            ds = Middlebury(aug_params, root=osp.join(root, "Middlebury"),
                            split=name.replace("middlebury_", ""))
        elif name == "sceneflow":
            clean = SceneFlow(aug_params, root=root, dstype="frames_cleanpass")
            final = SceneFlow(aug_params, root=root, dstype="frames_finalpass")
            ds = (clean * 4) + (final * 4)
        elif "kitti" in name:
            ds = KITTI(aug_params, root=osp.join(root, "KITTI"), split=name)
        elif name == "sintel_stereo":
            ds = SintelStereo(aug_params, root=osp.join(root, "SintelStereo")) * 140
        elif name == "falling_things":
            ds = FallingThings(aug_params,
                               root=osp.join(root, "FallingThings")) * 5
        elif name.startswith("tartan_air"):
            ds = TartanAir(aug_params, root=root,
                           keywords=name.split("_")[2:])
        else:
            raise ValueError(f"unknown training dataset {name!r}")
        logger.info("Adding %d samples from %s", len(ds), name)
        combined = ds if combined is None else combined + ds
    if combined is None or len(combined) == 0:
        raise ValueError(f"no training data found for {list(train_datasets)}")
    logger.info("Training with %d image pairs", len(combined))
    return combined


def train_aug_params(cfg) -> dict:
    """The augmentation parameters of a ``TrainConfig``."""
    aug_params = {
        "crop_size": tuple(cfg.image_size),
        "min_scale": cfg.spatial_scale[0],
        "max_scale": cfg.spatial_scale[1],
        "do_flip": cfg.do_flip,
        "yjitter": not cfg.noyjitter,
    }
    if cfg.saturation_range is not None:
        aug_params["saturation_range"] = tuple(cfg.saturation_range)
    if cfg.img_gamma is not None:
        aug_params["gamma"] = tuple(cfg.img_gamma)
    return aug_params


def fetch_dataloader(cfg, root: Optional[str] = None):
    """The training loader of a ``TrainConfig`` (the reference's
    train_stereo.py surface)."""
    from raft_stereo_tpu_torch.data.loader import Loader

    dataset = build_train_dataset(cfg.train_datasets, train_aug_params(cfg),
                                  root=root or cfg.data_root)
    return Loader(dataset, batch_size=cfg.batch_size, seed=cfg.seed,
                  num_workers=cfg.num_workers, drop_last=True, shuffle=True)
