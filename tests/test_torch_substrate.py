"""Port parity: data pipelines, checkpoints and fault tolerance
(``repro_torch.data``, ``repro_torch.distributed``) against the JAX
package's, and twins of ``tests/test_substrate.py``'s tests of them.

Exact throughout: pipeline batches, checkpoint leaf files (byte for
byte) and manifest records, restored values, and the supervised run's
final state against an uninterrupted one.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import pipeline as JP  # noqa: E402
from repro.distributed import checkpoint as JC  # noqa: E402
from repro.train import optim as JO  # noqa: E402
from repro_torch.bridge import (opt_state_from_numpy,  # noqa: E402
                                params_from_numpy, tree_leaves)
from repro_torch.data import pipeline as TP  # noqa: E402
from repro_torch.distributed import checkpoint as TC  # noqa: E402
from repro_torch.distributed.ft import (HeartbeatMonitor,  # noqa: E402
                                        TrainSupervisor, WorkerFailure,
                                        plan_elastic_mesh)

jax.config.update("jax_platform_name", "cpu")


# ------------------------------- data ---------------------------------------

@pytest.mark.parametrize("seed,rank,world", [(0, 0, 1), (1, 0, 2), (1, 1, 2),
                                             (7, 3, 4)])
def test_token_pipeline_batches_equal_reference(seed, rank, world):
    kw = dict(vocab=300, seq_len=24, batch=3, seed=seed, rank=rank,
              world=world)
    jp, tp = JP.TokenPipeline(**kw), TP.TokenPipeline(**kw)
    for step in (0, 1, 5, 1000):
        a, b = jp.batch_at(step), tp.batch_at(step)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("seed,rank,world", [(0, 0, 1), (3, 1, 2)])
def test_image_and_latent_pipelines_equal_reference(seed, rank, world):
    kw = dict(seed=seed, rank=rank, world=world)
    for jp, tp in ((JP.ImagePipeline(img_res=20, batch=4, n_classes=5, **kw),
                    TP.ImagePipeline(img_res=20, batch=4, n_classes=5, **kw)),
                   (JP.LatentPipeline(latent_res=8, channels=4, batch=2,
                                      ctx_len=5, ctx_dim=6, **kw),
                    TP.LatentPipeline(latent_res=8, channels=4, batch=2,
                                      ctx_len=5, ctx_dim=6, **kw))):
        for step in (0, 3):
            a, b = jp.batch_at(step), tp.batch_at(step)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


def test_token_pipeline_deterministic_and_rank_disjoint():
    p0 = TP.TokenPipeline(vocab=64, seq_len=16, batch=4, seed=1, rank=0,
                          world=2)
    p0b = TP.TokenPipeline(vocab=64, seq_len=16, batch=4, seed=1, rank=0,
                           world=2)
    p1 = TP.TokenPipeline(vocab=64, seq_len=16, batch=4, seed=1, rank=1,
                          world=2)
    b0, b0b, b1 = p0.batch_at(5), p0b.batch_at(5), p1.batch_at(5)
    np.testing.assert_array_equal(b0["tokens"], b0b["tokens"])
    assert not np.array_equal(b0["tokens"], b1["tokens"])
    np.testing.assert_array_equal(b0["tokens"][:, 1:], b0["labels"][:, :-1])


def test_image_pipeline_learnable_signal():
    b = TP.ImagePipeline(img_res=16, batch=8, n_classes=3, seed=0).batch_at(0)
    assert b["image"].shape == (8, 16, 16, 3)
    assert set(np.unique(b["label"])) <= {0, 1, 2}


def test_prefetcher_yields_in_order():
    pipe = TP.TokenPipeline(vocab=16, seq_len=4, batch=2, seed=3)
    pf = TP.Prefetcher(iter(pipe), depth=2)
    for step in range(4):
        np.testing.assert_array_equal(next(pf)["tokens"],
                                      pipe.batch_at(step)["tokens"])
    pf.close()


# ----------------------------- checkpoints ----------------------------------

def _jax_tree():
    rng = np.random.RandomState(0)
    params = {"w": jnp.asarray(rng.randn(3, 130), jnp.float32),
              "h": jnp.asarray(rng.randn(2, 4, 128), jnp.bfloat16),
              "q": jnp.asarray(rng.randint(-128, 128, (5,)), jnp.int8),
              "ids": jnp.asarray(rng.randint(0, 9, (2, 3)), jnp.int32),
              "shards": [jnp.asarray(rng.randn(2), jnp.float32),
                         jnp.asarray(rng.randn(2), jnp.bfloat16)]}
    opt = JO.adamw8bit_init({k: params[k] for k in ("w", "h")})
    opt = opt._replace(m_q={"w": jnp.asarray(rng.randint(-9, 9, (3, 130)),
                                             jnp.int8), "h": opt.m_q["h"]})
    return {"params": params, "opt": opt, "step": jnp.int32(7)}


def _port_tree(jtree):
    np_tree = jax.tree_util.tree_map(np.asarray, jtree)
    return {"params": params_from_numpy(np_tree["params"], device="cpu"),
            "opt": opt_state_from_numpy(np_tree["opt"], device="cpu"),
            "step": torch.tensor(7, dtype=torch.int32)}


def test_checkpoint_files_are_the_references_byte_for_byte(tmp_path):
    jtree = _jax_tree()
    JC.save_checkpoint(tmp_path / "jax", 3, jtree, metadata={"a": 1})
    TC.save_checkpoint(tmp_path / "port", 3, _port_tree(jtree),
                       metadata={"a": 1})
    jd, td = tmp_path / "jax/step_000000003", tmp_path / "port/step_000000003"
    jm = json.loads((jd / "manifest.json").read_text())
    tm = json.loads((td / "manifest.json").read_text())
    assert tm["leaves"] == jm["leaves"]
    assert (tm["step"], tm["metadata"]) == (jm["step"], jm["metadata"])
    assert tm["treedef"] == jm["treedef"]
    assert {r["dtype"] for r in tm["leaves"]} == {"float32", "bfloat16",
                                                 "int8", "int32"}
    for rec in jm["leaves"]:
        assert (td / rec["file"]).read_bytes() == \
            (jd / rec["file"]).read_bytes(), rec["path"]


def test_port_restores_a_jax_checkpoint(tmp_path):
    jtree = _jax_tree()
    JC.save_checkpoint(tmp_path, 5, jtree)
    like = _port_tree(jtree)
    like = {**like, "params": {**like["params"],
                               "w": torch.zeros(3, 130)}}
    restored, step, _ = TC.restore_checkpoint(tmp_path, like, device="cpu")
    assert step == 5
    want = tree_leaves(_port_tree(jtree))
    got = tree_leaves(restored)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # and the reference restores the port's (a tree without bf16 leaves:
    # the reference's own restore cannot cast a '<V2' file to bfloat16)
    jf32 = {"w": jtree["params"]["w"], "q": jtree["params"]["q"],
            "step": jtree["step"]}
    TC.save_checkpoint(tmp_path / "p", 1, {
        "w": like["params"]["w"].add_(3), "q": like["params"]["q"],
        "step": like["step"]})
    back, _, _ = JC.restore_checkpoint(tmp_path / "p", jf32)
    np.testing.assert_array_equal(np.asarray(back["w"]),
                                  np.asarray(jf32["w"]) * 0 + 3)
    np.testing.assert_array_equal(np.asarray(back["q"]),
                                  np.asarray(jf32["q"]))
    assert back["step"].dtype == jnp.int32


def test_checkpoint_roundtrip(tmp_path):
    tree = {"w": torch.arange(6.0).reshape(2, 3), "opt": {"m": torch.ones(3)},
            "step": torch.tensor(7, dtype=torch.int32)}
    TC.save_checkpoint(tmp_path, 42, tree, metadata={"note": "hi"})
    restored, step, meta = TC.restore_checkpoint(tmp_path, tree)
    assert step == 42 and meta["note"] == "hi"
    assert torch.equal(restored["w"], tree["w"])
    assert restored["step"].dtype == torch.int32


def test_checkpoint_retention_and_latest(tmp_path):
    tree = {"x": torch.zeros(2)}
    for s in (1, 2, 3, 4):
        TC.save_checkpoint(tmp_path, s, tree, keep=2)
    assert TC.latest_step(tmp_path) == 4
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["step_000000003", "step_000000004"]
    assert TC.latest_step(tmp_path / "none") is None
    with pytest.raises(FileNotFoundError):
        TC.restore_checkpoint(tmp_path / "none", tree)
    with pytest.raises(ValueError):
        TC.restore_checkpoint(tmp_path, {"x": tree["x"], "y": tree["x"]})


def test_checkpoint_manager_async(tmp_path):
    mgr = TC.CheckpointManager(tmp_path, every=2, async_save=True)
    tree = {"x": torch.ones(4)}
    assert not mgr.maybe_save(1, tree)
    assert mgr.maybe_save(2, tree)
    tree["x"].add_(5)              # the host copy was taken already
    mgr.wait()
    assert TC.latest_step(tmp_path) == 2
    restored, _, _ = TC.restore_checkpoint(tmp_path, tree)
    assert torch.equal(restored["x"], torch.ones(4))


def test_checkpoint_manager_reraises_a_failed_save(tmp_path):
    (tmp_path / "file").write_text("not a directory")
    mgr = TC.CheckpointManager(tmp_path / "file", every=1)
    mgr.maybe_save(1, {"x": torch.ones(1)})
    with pytest.raises(OSError):
        mgr.wait()


# -------------------------- fault tolerance ----------------------------------

def test_heartbeat_detects_dead_and_straggler():
    mon = HeartbeatMonitor(n_ranks=4, timeout_s=5.0, straggler_factor=2.0)
    for r in range(4):
        mon.beat(r, step_time_s=1.0 if r != 2 else 5.0, now=100.0)
    assert mon.dead_ranks(now=103.0) == []
    mon.beat(0, now=103.0)
    assert mon.dead_ranks(now=106.0) == [1, 2, 3]
    assert mon.stragglers() == [2]
    assert 2 not in mon.healthy_ranks()


def test_plan_elastic_mesh_shrinks_data_axis():
    assert plan_elastic_mesh(256, model_parallel=16) == (16, 16)
    assert plan_elastic_mesh(240, model_parallel=16) == (15, 16)
    assert plan_elastic_mesh(8, model_parallel=16) == (1, 8)


def _make_step(fail_at=frozenset()):
    fired = set()

    def step_fn(state, step):
        if step in fail_at and step not in fired:
            fired.add(step)
            raise WorkerFailure(f"node died at {step}")
        new = {"w": state["w"] + 0.5 ** (step + 1)}
        return new, {"w": float(new["w"])}
    return step_fn


def test_supervisor_restart_is_bit_exact(tmp_path):
    start = {"w": torch.tensor(0.0)}
    clean, _ = TrainSupervisor(str(tmp_path / "clean"), ckpt_every=1).run(
        start, _make_step(), 8)
    faulty, hist = TrainSupervisor(str(tmp_path / "faulty"),
                                   ckpt_every=1).run(
        start, _make_step(fail_at={3, 6}), 8)
    assert torch.equal(clean["w"], faulty["w"])
    assert [h["step"] for h in hist] == [1, 2, 3, 4, 5, 6, 7, 8]


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    sup = TrainSupervisor(str(tmp_path), ckpt_every=1, max_restarts=1)
    with pytest.raises(WorkerFailure):
        sup.run({"w": torch.tensor(0.0)},
                lambda s, i: (_ for _ in ()).throw(WorkerFailure("x")), 3)
