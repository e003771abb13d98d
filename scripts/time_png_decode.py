#!/usr/bin/env python3
"""Time the port's PNG decoder (``raft_stereo_tpu_torch/data/png.py``) on
a KITTI-size frame, per row filter, on the host it runs on.

    python3 scripts/time_png_decode.py [--png PATH] [--label NAME]
        [--reps N]

``--png`` is the ``png.py`` file to time (default: this checkout's), so
two versions are compared in one process on the same bytes. The images
are made from a seed: a 375x1242 RGB picture (4x4 blocks of uniform
noise plus Gaussian noise, as chip_smoke.py's ``stereo_pair`` makes) and
a 16-bit disparity map (a constant with a fifth of the pixels 0), each
encoded with every row filter by the decoder's own ``encode_png``. For
each it prints one JSON line: the filter, the image, the minimum and the
median of ``--reps`` decodes in ms (the first decode builds the
predictor tables, which the minimum leaves out), and that the array came
back exactly.
"""

import argparse
import importlib.util
import json
import os
import statistics
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def images(seed=0, h=375, w=1242):
    rng = np.random.default_rng(seed)
    small = rng.uniform(0, 255, (h // 4 + 2, w // 4 + 2, 3))
    rgb = np.kron(small, np.ones((4, 4, 1)))[:h, :w]
    rgb = np.clip(rgb + rng.normal(0, 8, rgb.shape), 0, 255).astype(np.uint8)
    disp = np.full((h, w), 12 * 256, np.uint16)
    disp[rng.uniform(size=(h, w)) < 0.2] = 0
    return {"rgb": rgb, "disp16": disp}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--png", default=os.path.join(
        ROOT, "raft_stereo_tpu_torch", "data", "png.py"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    spec = importlib.util.spec_from_file_location("png_under_test",
                                                  args.png)
    png = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(png)
    for filter_type in range(5):
        for name, arr in images().items():
            data = png.encode_png(arr, filter_type)
            times, exact = [], True
            for _ in range(args.reps):
                t0 = time.perf_counter()
                out = png.decode_png(data)
                times.append(time.perf_counter() - t0)
                exact = exact and np.array_equal(out, arr)
            print(json.dumps({
                "label": args.label, "filter": filter_type, "image": name,
                "shape": list(arr.shape), "min_ms": min(times) * 1e3,
                "median_ms": statistics.median(times) * 1e3,
                "exact": exact}), flush=True)


if __name__ == "__main__":
    main()
