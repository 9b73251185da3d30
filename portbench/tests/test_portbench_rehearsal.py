"""A tiny-size CPU rehearsal of each traffic mix against the reference: the
whole run, untraced and traced, prints a result line in the shape a run's result takes,
with every compared number beside its limit."""

import pytest

from portbench_tiny import CELLS, make_tree, run_cell


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("portbench_rehearsal"))


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal(tree, cell, trace):
    r = run_cell(tree, cell, 2**31 + 17, trace=trace)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] and r["failed"] == 0
    for name, c in r["checks"].items():
        assert c["value"] is not None and c["value"] <= c["limit"], name
    e2e = {"setup_s"} | {"tiny.fit": {"fit_ms", "fit_p95_ms"}, "tiny.train": {"train_step_ms"},
                         "tinybreath.train": {"short_step_ms"}}[cell]
    if trace:
        # the CPU has no device: only the metrics of the host clock are written (the
        # untraced window's share of the peak), and the breakdown is there
        mfu = {"tiny.fit": "fit_mfu", "tiny.train": "train_mfu", "tinybreath.train": "short_step_mfu"}[cell]
        assert set(r["metrics"]) == {mfu} and "breakdown" in r
        assert r["device"]["window_s"] > 0
    else:
        assert set(r["metrics"]) == e2e
        assert all(m["value"] > 0 for m in r["metrics"].values())


def test_same_seed_same_inputs():
    import torch

    from portbench.core import manifest

    for cfg_name in ("bench16k", "breathing3773"):
        cfg = dict(manifest.config(cfg_name), n=300)
        recipe = manifest.load_module("data", cfg["data"]["recipe"])
        a = recipe.make(cfg, 2**33 + 1, 2, torch.device("cpu"))
        b = recipe.make(cfg, 2**33 + 1, 2, torch.device("cpu"))
        c = recipe.make(cfg, 2**33 + 2, 2, torch.device("cpu"))
        assert all(torch.equal(x, y) for p, q in zip(a, b) for x, y in zip(p, q))
        assert not torch.equal(a[0][0], c[0][0])
        assert not torch.equal(a[0][0], a[1][0])  # datasets differ
