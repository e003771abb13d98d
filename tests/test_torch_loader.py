"""The port's loader (``raft_stereo_tpu_torch/data/loader.py``) against the
JAX package's ``raft_stereo_tpu.data.loader.Loader``, on the CPU.

On a dense (FlyingThings, mixed as ``build_train_dataset`` mixes
"sceneflow") and a sparse (KITTI) tree with the recipe's
augmentation: two epochs, a mid-epoch ``start_batch`` resume, epochs that
differ; images and valid masks bitwise equal to the JAX loader's batches,
flow within FLOW_REL of its largest magnitude (the augmentor's float
resize, tests/test_torch_augment.py), whatever the number of worker
processes. On a stub dataset, as the
JAX package's tests/test_resilience.py drives its loader: transient
failures retried away, quarantine records equal to JAX's with every other
slot untouched, and a wholly broken dataset failing fast.
"""

import numpy as np
import pytest

from raft_stereo_tpu.data import datasets as jds
from raft_stereo_tpu.data.loader import Loader as JLoader
from raft_stereo_tpu_torch.data import datasets as tds
from raft_stereo_tpu_torch.data.loader import Loader, infinite_batches

import torch_parity as tp
from loader_stub import ArrayDataset
from torch_parity import (jax_readers_without_native,  # noqa: F401
                          torch_one_thread)

FLOW_REL = 4e-5
AUG = {"crop_size": (32, 48), "min_scale": -0.2, "max_scale": 0.4,
       "do_flip": None, "yjitter": True, "saturation_range": (0.0, 1.4)}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    from chip_smoke import write_sceneflow_tree
    root = tmp_path_factory.mktemp("loader")
    write_sceneflow_tree(str(root), 5, 48, 96, 3, max_disp=12)
    tp.write_kitti(root, np.random.default_rng(4), n=6)
    return root


def _datasets(trees, kind):
    if kind == "dense":  # the reference's mix: clean x 4 + final x 4
        return (jds.build_train_dataset(("sceneflow",), AUG, str(trees)),
                tds.build_train_dataset(("sceneflow",), AUG, str(trees)))
    aug = dict(AUG, do_flip="h")
    return (jds.KITTI(aug, root=str(trees / "KITTI")),
            tds.KITTI(aug, root=str(trees / "KITTI")))


def _equal(got, want, record=None):
    assert len(got) == len(want) > 0
    worst = 0.0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, k
            if k == "flow":
                worst = max(worst, float(np.abs(g[k] - w[k]).max()
                                         / max(np.abs(w[k]).max(), 1.0)))
            else:
                assert np.array_equal(g[k], w[k]), k
    assert worst <= FLOW_REL
    return worst


@pytest.mark.parametrize("kind,workers", [("dense", 2), ("dense", 3),
                                          ("sparse", 2)])
def test_epochs_and_resume_match_jax(trees, kind, workers, record_property):
    jset, tset = _datasets(trees, kind)
    assert len(jset) == len(tset) >= 6
    want = JLoader(jset, batch_size=2, seed=7, num_workers=2)
    epochs = [list(want), list(want)]
    got = Loader(tset, batch_size=2, seed=7, num_workers=workers)
    try:
        worst = max(_equal(list(got), epochs[0]),
                    _equal(list(got), epochs[1]))
        assert not np.array_equal(epochs[0][0]["image1"],
                                  epochs[1][0]["image1"])  # epochs differ
        # a run restored at global step len + 2: epoch 1, batch 2
        got.epoch, got.start_batch = 1, 2
        tail = list(got)
        assert len(tail) == len(epochs[1]) - 2
        worst = max(worst, _equal(tail, epochs[1][2:]))
        assert got.start_batch == 0  # consumed once: the next epoch is whole
        nxt = list(got)
        jnext = list(want)
        worst = max(worst, _equal(nxt, jnext))
    finally:
        got.close()
    record_property("flow_max_rel_dev", worst)


def _collect(loader, n):
    stream = infinite_batches(loader)
    out = [next(stream) for _ in range(n)]
    stream.close()
    return out


def _same(a, b):
    return all(np.array_equal(x[k], y[k]) for x, y in zip(a, b) for k in x)


def test_retry_recovers_transient_failures():
    clean = _collect(JLoader(ArrayDataset(), 2, seed=3, num_workers=2), 8)
    flaky = Loader(ArrayDataset(fail_times={1: 1, 5: 2}), 2, seed=3,
                   num_workers=2, decode_retries=2, retry_backoff_s=0.001)
    assert _same(clean, _collect(flaky, 8))
    assert not flaky.quarantined  # the retries absorbed the failures
    flaky.close()


@pytest.mark.parametrize("workers", [1, 2])
def test_quarantine_records_match_jax(workers):
    records, jrecords = [], []
    want_loader = JLoader(ArrayDataset(fail=(5,)), 2, seed=3, num_workers=2,
                          decode_retries=1, retry_backoff_s=0.001)
    want_loader.quarantine_hook = jrecords.append
    want = _collect(want_loader, 8)
    got_loader = Loader(ArrayDataset(fail=(5,)), 2, seed=3,
                        num_workers=workers, decode_retries=1,
                        retry_backoff_s=0.001)
    got_loader.quarantine_hook = records.append
    got = _collect(got_loader, 8)
    got_loader.close()
    assert _same(got, want)
    assert records == jrecords == got_loader.quarantined \
        == want_loader.quarantined
    assert [(r["epoch"], r["index"], r["substitute"]) for r in records] \
        == [(0, 5, 6), (1, 5, 6)]
    # every slot the broken sample did not hit is the clean stream's
    clean_loader = Loader(ArrayDataset(), 2, seed=3, num_workers=2)
    clean = _collect(clean_loader, 8)
    clean_loader.close()
    differing = sum(not np.array_equal(c[k], g[k])
                    for c, g in zip(clean, got) for k in c)
    assert differing == 2 * 3  # two substituted slots; valid is all ones


@pytest.mark.parametrize("workers", [1, 2])
def test_all_broken_fails_fast(workers):
    loader = Loader(ArrayDataset(n=4, fail=(0, 1, 2, 3)), 2, seed=0,
                    num_workers=workers, decode_retries=0,
                    retry_backoff_s=0.001)
    with pytest.raises(IOError, match="decode failed"):
        _collect(loader, 1)
    loader.close()
