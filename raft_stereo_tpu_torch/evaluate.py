"""Evaluation entry point: ``python -m raft_stereo_tpu_torch.evaluate``.

The JAX package's ``evaluate_stereo.py`` surface (``cli.build_eval_parser``)
on the port: one validator over a dataset tree, sequential or streamed,
with ``events.jsonl`` telemetry under ``--run_dir``; the results dict is
printed last. As in the reference, the kernel correlations run in mixed
precision. Weights come from ``--restore_ckpt``, a reference ``.pth`` or a
checkpoint directory of the port's trainer (``utils/weights.load_weights``),
or, without one, from seed 0. Like every entry point of the port it leaves
PyTorch's TF32 settings as they are.
"""

from __future__ import annotations

import logging

from raft_stereo_tpu_torch import cli
from raft_stereo_tpu_torch.eval.stream import StreamConfig
from raft_stereo_tpu_torch.eval.validate import VALIDATORS, validate_middlebury
from raft_stereo_tpu_torch.inference import StereoPredictor
from raft_stereo_tpu_torch.obs import Telemetry
from raft_stereo_tpu_torch.utils.weights import load_weights

logger = logging.getLogger(__name__)


def main(argv=None) -> None:
    args = cli.build_eval_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(filename)s:%(lineno)d %(message)s")
    if args.iter_epe or args.iter_policy:
        raise ValueError("--iter_epe and --iter_policy need the model's "
                         "per-iteration outputs, which are not ported yet "
                         "(ROADMAP A11)")
    # the kernel implementations run in mixed precision, as the reference's
    if (args.corr_implementation.endswith(("_cuda", "_pallas"))
            or args.corr_implementation in ("fused", "memoryless")) \
            and not args.mixed_precision:
        logger.info("enabling mixed precision for %s",
                    args.corr_implementation)
        args.mixed_precision = True
    cfg = cli.model_config(args)
    predictor = StereoPredictor(cfg, load_weights(args.restore_ckpt, cfg),
                                valid_iters=args.valid_iters,
                                bucket=args.bucket, device=args.device)
    stream = StreamConfig(
        enabled={"auto": None, "on": True, "off": False}[args.stream],
        window=args.stream_window, microbatch=args.stream_microbatch,
        decode_workers=args.decode_workers)
    tel = None
    if args.run_dir:
        tel = Telemetry(args.run_dir, stall_deadline_s=None,
                        device=predictor.device)
        tel.run_start(config={"dataset": args.dataset,
                              "valid_iters": args.valid_iters,
                              "stream": args.stream,
                              "stream_window": args.stream_window,
                              "stream_microbatch": args.stream_microbatch,
                              "converge": False, "iter_epe": False,
                              "numerics": False, "iter_policy": None,
                              "iter_policy_digest": None,
                              "device": str(predictor.device)})
    try:
        if args.dataset.startswith("middlebury_"):
            results = validate_middlebury(predictor, args.data_root,
                                          args.valid_iters,
                                          split=args.dataset.split("_")[1],
                                          telemetry=tel, stream=stream)
        else:
            results = VALIDATORS[args.dataset](predictor, args.data_root,
                                               args.valid_iters,
                                               telemetry=tel, stream=stream)
    except BaseException as e:
        if tel is not None:
            tel.error(e)
            tel.emit("run_end", steps=0, ok=False)
            tel.close()
        raise
    if tel is not None:
        tel.emit("run_end", steps=tel.steps, ok=True)
        tel.close()
    print(results)


if __name__ == "__main__":
    main()
