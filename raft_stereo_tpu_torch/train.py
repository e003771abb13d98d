"""Training entry point: ``python -m raft_stereo_tpu_torch.train``.

The JAX package's training command line (``cli.build_train_parser``: the
reference's train_stereo.py flags) on the port, on the card unless
``--device cpu``; it prints ``final checkpoint: <path>`` last. The
SceneFlow recipe:

    python -m raft_stereo_tpu_torch.train --batch_size 8 --train_iters 22 \\
        --spatial_scale -0.2 0.4 --saturation_range 0 1.4 --mixed_precision

This module imports the trainer only inside :func:`main`: the loader's
worker processes import the program's main module, and stay light so.
"""

from __future__ import annotations

import logging


def main(argv=None) -> None:
    from raft_stereo_tpu_torch import cli
    from raft_stereo_tpu_torch.training.trainer import train

    args = cli.build_train_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(filename)s:%(lineno)d %(message)s")
    final = train(cli.model_config(args), cli.train_config(args),
                  device=args.device)
    print(f"final checkpoint: {final}", flush=True)


if __name__ == "__main__":
    main()
