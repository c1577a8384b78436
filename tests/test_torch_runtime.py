"""The port's gradient compression (``repro_torch.optim.compress``) and
fault tolerance (``repro_torch.runtime.fault``) held against the JAX
package's ``repro.optim.compress`` and ``repro.runtime.fault``.

Compression is held bit for bit: the quantized values, the scales, the
decompressed gradients and the residuals, on float32 and bfloat16
gradients, an all-zero tensor (the 1e-12 clamp) and exact halves (round
half to even). The runner's replay after injected failures equals a run
without failures bit for bit, and its list of replayed steps equals the
reference runner's for the same schedule; the balancer's assignment and
the elastic re-shard equal the reference's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.optim import compress as jcomp  # noqa: E402
from repro.runtime import fault as jfault  # noqa: E402
from repro.runtime.checkpoint import CheckpointManager as JCheckpoint  # noqa: E402
from repro_torch.data import DataCursor  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    adamw_init,
    compress_int8,
    decompress_int8,
    ef_compress_update,
    init_residuals,
)
from repro_torch.runtime import (  # noqa: E402
    CheckpointManager,
    FaultTolerantRunner,
    StepFailure,
    StragglerBalancer,
    reshard_state,
)
from repro_torch.tree import tree_leaves  # noqa: E402

# ckpt_every, failures, steps of the drill (and of chip_smoke.py's 13c)
DRILL = dict(ckpt_every=2, fail_at={3, 6}, n_steps=8)
DRILL_REPLAYED = [2, 3, 6]


def _bf16_pair(a32):
    """The same bfloat16 values as a tensor and as a JAX array."""
    t = torch.from_numpy(a32).to(torch.bfloat16)
    bits = t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t, jnp.asarray(bits)


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.float() if x.dtype == torch.bfloat16 else x
        return x.numpy()
    return np.asarray(x).astype(np.float32) if x.dtype == jnp.bfloat16 \
        else np.asarray(x)


def _same(got, want):
    np.testing.assert_array_equal(_np(got), _np(want))
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)


def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((33, 7)) * 1e-3).astype(np.float32),
            "b": rng.standard_normal(129).astype(np.float32) * 50,
            "zero": np.zeros((4, 4), np.float32),
            "halves": np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, 126.5],
                               np.float32)}


@pytest.mark.parametrize("name", ["w", "b", "zero", "halves"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_and_decompress_equal_the_reference(name, dtype):
    a = _grads(0)[name]
    t, j = ((torch.from_numpy(a), jnp.asarray(a)) if dtype == "float32"
            else _bf16_pair(a))
    tq, ts = compress_int8(t)
    jq, js = jcomp.compress_int8(j)
    _same(tq, jq)
    _same(ts, js)
    _same(decompress_int8(tq, ts), jcomp.decompress_int8(jq, js))
    if name == "halves":     # 1.5 and 2.5 both round to 2, -0.5 to -0
        assert tq.tolist() == [127, 0, 2, 2, 0, -2, 4, 126]
    if name == "zero":
        assert float(ts) == np.float32(1e-12) / np.float32(127.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_error_feedback_rounds_equal_the_reference(dtype):
    """Five rounds over fresh gradients, the residuals carried: every
    round's gradients (in their dtype) and residuals (float32) bit for
    bit."""
    tg0 = {k: torch.from_numpy(v) for k, v in _grads(0).items()}
    tres, jres = init_residuals(tg0), jcomp.init_residuals(
        {k: jnp.asarray(v) for k, v in _grads(0).items()})
    for i in range(5):
        g = _grads(i)
        if dtype == "float32":
            tg = {k: torch.from_numpy(v) for k, v in g.items()}
            jg = {k: jnp.asarray(v) for k, v in g.items()}
        else:
            pairs = {k: _bf16_pair(v) for k, v in g.items()}
            tg = {k: p[0] for k, p in pairs.items()}
            jg = {k: p[1] for k, p in pairs.items()}
        tc, tres = ef_compress_update(tg, tres)
        jc, jres = jcomp.ef_compress_update(jg, jres)
        for k in g:
            _same(tc[k], jc[k])
            _same(tres[k], jres[k])


def test_error_feedback_tracks_the_signal():
    """The reference's drift test: over 30 rounds the compressed sum stays
    within 2% of the true sum (the reference's gradients), and every
    round equals the reference's bit for bit."""
    key = jax.random.PRNGKey(0)
    true_sum = np.zeros(256, np.float32)
    sent = torch.zeros(256)
    tres, jres = {"g": torch.zeros(256)}, {"g": jnp.zeros((256,))}
    for i in range(30):
        g = jax.random.normal(jax.random.fold_in(key, i), (256,)) * (1 + i % 3)
        jc, jres = jcomp.ef_compress_update({"g": g}, jres)
        tc, tres = ef_compress_update({"g": torch.from_numpy(np.array(g))},
                                      tres)
        _same(tc["g"], jc["g"])
        true_sum = true_sum + np.asarray(g)
        sent = sent + tc["g"]
    err = np.linalg.norm(true_sum - sent.numpy()) / np.linalg.norm(true_sum)
    assert err < 0.02


# -- the fault-tolerant runner ------------------------------------------------------

def _gcn_drill():
    """(state, step_fn) of the reduced gcn-cora's training: the step's
    batch is the data cursor's at (0, step)."""
    _, _, params_init, loss_fn, data_fn = ttrain.build("gcn-cora", True, 8,
                                                       128, "cpu")
    params = params_init(torch.Generator().manual_seed(0))

    def step_fn(state, step):
        p, o, _, _ = ttrain.train_step(loss_fn, state["params"],
                                       state["opt"],
                                       data_fn(DataCursor(0, step)), lr=1e-2)
        return {"params": p, "opt": o}
    return {"params": params, "opt": adamw_init(params)}, step_fn


def test_runner_replay_equals_a_run_without_failures(tmp_path):
    state, step_fn = _gcn_drill()
    straight = state
    for step in range(DRILL["n_steps"]):
        straight = step_fn(straight, step)
    runner = FaultTolerantRunner(CheckpointManager(str(tmp_path / "t"),
                                                   device="cpu"),
                                 ckpt_every=DRILL["ckpt_every"])
    got, replayed = runner.run(state, step_fn, DRILL["n_steps"],
                               fail_at=DRILL["fail_at"])
    assert replayed == DRILL_REPLAYED
    assert int(got["opt"].count) == DRILL["n_steps"]
    for a, b in zip(tree_leaves(got), tree_leaves(straight)):
        assert a.dtype == b.dtype and torch.equal(a, b)

    # the reference's runner on the same schedule replays the same steps
    jrunner = jfault.FaultTolerantRunner(JCheckpoint(str(tmp_path / "j")),
                                         ckpt_every=DRILL["ckpt_every"])
    _, jreplayed = jrunner.run({"x": np.zeros(2)},
                               lambda s, i: {"x": s["x"] + i},
                               DRILL["n_steps"], fail_at=DRILL["fail_at"])
    assert jreplayed == replayed


@pytest.mark.parametrize("every,fail_at,n", [(3, {5, 10}, 12), (1, {0, 4}, 6),
                                             (4, {2, 3, 9}, 10)])
def test_runner_replays_as_the_reference(tmp_path, every, fail_at, n):
    """The replayed steps and the final step count, schedule by schedule,
    against the reference runner."""
    def step_fn(state, step):
        return {"x": state["x"] + (step + 1)}
    runner = FaultTolerantRunner(CheckpointManager(str(tmp_path / "t"),
                                                   device="cpu"),
                                 ckpt_every=every)
    got, replayed = runner.run({"x": torch.zeros(2)}, step_fn, n,
                               fail_at=fail_at)
    jrunner = jfault.FaultTolerantRunner(JCheckpoint(str(tmp_path / "j")),
                                         ckpt_every=every)
    want, jreplayed = jrunner.run({"x": np.zeros(2)}, step_fn, n,
                                  fail_at=fail_at)
    assert replayed == jreplayed
    np.testing.assert_array_equal(got["x"].numpy(), np.asarray(want["x"]))


def test_runner_gives_up_after_max_retries(tmp_path):
    runner = FaultTolerantRunner(CheckpointManager(str(tmp_path), device="cpu"),
                                 ckpt_every=100, max_retries=2)
    runner.ckpt.save(0, {"x": 0})
    calls = []

    def bad(state, step):
        calls.append(step)
        raise StepFailure("always down")
    with pytest.raises(StepFailure, match="always down"):
        runner.run({"x": 0}, bad, 3)
    assert calls == [0, 0, 0]      # the first try and 2 retries


def test_straggler_balancer_assigns_as_the_reference():
    """Seeded costs with ties (rounded to tenths), several observations per
    block, blocks never observed: the same assignment and imbalance."""
    rng = np.random.default_rng(7)
    ours, ref = StragglerBalancer(5), jfault.StragglerBalancer(5)
    for _ in range(3):
        for b in range(30):
            c = float(np.round(rng.random() * 3, 1))
            ours.observe(b, c)
            ref.observe(b, c)
    blocks = list(range(36))
    got = ours.assign(blocks)
    assert got == ref.assign(blocks)
    assert ours.imbalance(got) == ref.imbalance(got)
    naive = {w: blocks[w::5] for w in range(5)}
    assert ours.imbalance(got) <= ours.imbalance(naive)


@pytest.mark.parametrize("new", [2, 8, 4])
def test_reshard_state_shrinks_and_grows_arrays_and_tensors(new):
    state = {"params": np.ones((8, 3)), "batch_buf": np.arange(16.0),
             "rows": np.arange(24).reshape(8, 3), "step": 7}
    want = jfault.reshard_state(state, 4, new, batch_linked=("batch_buf",
                                                             "rows"))
    got = reshard_state(state, 4, new, batch_linked=("batch_buf", "rows"))
    as_tensors = reshard_state(
        {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
         for k, v in state.items()}, 4, new,
        batch_linked=("batch_buf", "rows"))
    assert set(got) == set(want) == set(as_tensors)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(np.asarray(as_tensors[k]), want[k])
    assert got["batch_buf"].shape[0] == 16 // 4 * new
    assert isinstance(as_tensors["rows"], torch.Tensor)
