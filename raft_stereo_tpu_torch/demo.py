"""Inference demo: ``python -m raft_stereo_tpu_torch.demo``.

Globs left/right image pairs, runs the test-mode forward on the weights of
``--restore_ckpt`` (a reference ``.pth`` or a checkpoint directory of the
port's trainer, ``utils/weights.load_weights``) and writes
``<name>-disparity.png`` (jet colormap) and, with ``--save_numpy``, the
raw ``<name>.npy`` disparity. PIL and matplotlib are imported only when an
image is read or written.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from raft_stereo_tpu_torch import cli
from raft_stereo_tpu_torch.inference import StereoPredictor
from raft_stereo_tpu_torch.utils.weights import load_weights


def load_image(path: str) -> np.ndarray:
    from PIL import Image
    img = np.asarray(Image.open(path)).astype(np.uint8)
    if img.ndim == 2:
        img = np.tile(img[..., None], (1, 1, 3))
    return img[..., :3]


def save_colormapped(path: str, disparity: np.ndarray) -> None:
    import matplotlib.pyplot as plt
    plt.imsave(path, disparity, cmap="jet")


def main(argv=None) -> None:
    args = cli.build_demo_parser().parse_args(argv)
    cfg = cli.model_config(args)
    state = load_weights(args.restore_ckpt, cfg)
    predictor = StereoPredictor(cfg, state, valid_iters=args.valid_iters,
                                device=args.device)

    left_list = sorted(glob.glob(args.left_imgs, recursive=True))
    right_list = sorted(glob.glob(args.right_imgs, recursive=True))
    if not left_list or len(left_list) != len(right_list):
        raise SystemExit(f"found {len(left_list)} left / {len(right_list)} "
                         "right images; need matching non-empty lists")
    print(f"found {len(left_list)} image pairs; saving files to "
          f"{args.output_directory}/")
    os.makedirs(args.output_directory, exist_ok=True)

    for lpath, rpath in zip(left_list, right_list):
        disp = predictor.compute_disparity(load_image(lpath),
                                           load_image(rpath))
        stem = os.path.join(args.output_directory,
                            os.path.splitext(os.path.basename(lpath))[0])
        save_colormapped(f"{stem}-disparity.png", disp)
        if args.save_numpy:
            np.save(f"{stem}.npy", disp)
        print(f"{lpath}: disparity range "
              f"[{disp.min():.2f}, {disp.max():.2f}]")


if __name__ == "__main__":
    main()
