#!/usr/bin/env python3
"""Is the port's training run to run bitwise on the card?

    python3 scripts/train_determinism.py

Runs train() at the SceneFlow recipe (chip_smoke.recipe_config: reg_cuda,
bf16, batch 8 at 320x720, 22 iterations) for 6 steps on a synthetic
FlyingThings tree, twice with cuDNN's default algorithms and twice with
torch.backends.cudnn.deterministic, and once for 1 step under
torch.use_deterministic_algorithms(True, warn_only=True) to list the ops
PyTorch knows to be nondeterministic. Prints one JSON line a run (ms a
step, data_wait_s, losses, the warnings) and one a pair of runs (final
parameters bitwise equal, their relative L2 distance). Needs a card.
"""

import dataclasses
import json
import os
import sys
import tempfile
import warnings


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch
    import chip_smoke as cs
    from raft_stereo_tpu_torch.data.loader import stop_worker_server
    from raft_stereo_tpu_torch.ops.kernels import _build
    from raft_stereo_tpu_torch.training import trainer
    from raft_stereo_tpu_torch.training.checkpoint import load_payload

    if not torch.cuda.is_available():
        print("train_determinism: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    _build.build_all(["windowed_sample"])
    finals = {}
    with tempfile.TemporaryDirectory() as work:
        tree = cs.write_sceneflow_tree(os.path.join(work, "data"), 8,
                                       *cs.TRAIN_TREE_HW, 1434,
                                       test_frames=2)
        for label, det, warn in (("nondet_a", False, False),
                                 ("nondet_b", False, False),
                                 ("det_a", True, False),
                                 ("det_b", True, False),
                                 ("warn", False, True)):
            mcfg, tcfg = cs.recipe_config(tree, os.path.join(work, label),
                                          label)
            tcfg = dataclasses.replace(
                tcfg, num_steps=1 if warn else 6, checkpoint_frequency=None,
                validation_frequency=10 ** 6)
            torch.backends.cudnn.deterministic = det
            torch.use_deterministic_algorithms(warn, warn_only=True)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                final = trainer.train(mcfg, tcfg, device="cuda")
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic = False
            steps = [e for e in cs.step_records(
                os.path.join(tcfg.run_dir, label)) if e["event"] == "step"]
            finals[label] = load_payload(final)["model"]
            print(json.dumps({
                "run": label, "cudnn_deterministic": det,
                "ms_per_step": [1e3 * (e["data_wait_s"] + e["dispatch_s"]
                                       + e["fetch_s"]) for e in steps],
                "data_wait_s": [e["data_wait_s"] for e in steps],
                "losses": [e["loss"] for e in steps],
                "warnings": sorted({str(w.message)[:160] for w in caught
                                    if "determinis" in str(w.message)})}),
                flush=True)
    for a, b in (("nondet_a", "nondet_b"), ("det_a", "det_b"),
                 ("nondet_a", "det_a")):
        print(json.dumps({
            "pair": [a, b],
            "bitwise": all(torch.equal(finals[a][k], finals[b][k])
                           for k in finals[a]),
            "rel_l2": cs.param_distance(finals[a], finals[b])}), flush=True)
    stop_worker_server()
    return 0


if __name__ == "__main__":
    sys.exit(main())
