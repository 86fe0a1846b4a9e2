"""The training path of the port against the JAX package's, on the CPU.

Both packages start from one state: ``repro`` draws the parameters
(``repro.models.init_params``) and the port takes them as numpy
(``params_from_numpy``, ``train_state_from_numpy``); batches come from
each package's own ``SyntheticCorpus``, which must agree bit for bit.
Held: the data pipelines bitwise; ``cosine_schedule``; ``adamw_update``
fed ``repro``'s own gradients (moments bitwise, parameters within 2 ulp
of each leaf's max, the decay of stacked vectors included);
``compressed_gradients`` bitwise, ties at .5 included; the loss and
every gradient leaf of the first step of the gemma3-1b, jamba and
xlstm-1.3b SMOKE configs within 1e-4 of the leaf's max (xlstm-1.3b's
above its float32 noise floor), a train step with ``grad_accum=2`` and
``remat=True``, and the ``ssm_mode="seq"`` variant; three-step loss
trajectories of the two trainers with and without gradient compression;
a checkpoint of either trainer resumed by
the other; and ``launch/train.py --device cpu --smoke``.  The port runs
the kernels' plain versions here (and their ``autograd.Function``s,
whose backward is the same on the card)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro import optim as JO  # noqa: E402
from repro.data import SensorUpdateGenerator as JSensor  # noqa: E402
from repro.data import SyntheticCorpus as JCorpus  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training import TrainConfig as JTrainConfig  # noqa: E402
from repro.training import Trainer as JTrainer  # noqa: E402
from repro_torch import configs as PC  # noqa: E402
from repro_torch import optim as PO  # noqa: E402
from repro_torch.data import SensorUpdateGenerator as PSensor  # noqa: E402
from repro_torch.data import SyntheticCorpus as PCorpus  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.models import model as PM  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        train_state_from_numpy,
                                        train_state_to_numpy)
from repro_torch.training import TrainConfig, Trainer  # noqa: E402

ARCHS = ["gemma3-1b", "jamba-v0.1-52b", "xlstm-1.3b"]
B, L = 4, 32
TOL = 1e-4                       # of each leaf's max |repro|, float32


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _np(tree):
    return dict(_leaves(jax.tree.map(np.asarray, tree)))


def _torch_np(tree):
    return {p: t.detach().numpy() for p, t in _leaves(tree)}


def _close_per_leaf(got, want, tol=TOL):
    assert got.keys() == want.keys()
    for path, w in want.items():
        scale = max(float(np.max(np.abs(w))), 1e-30)
        err = float(np.max(np.abs(got[path] - w))) if w.size else 0.0
        assert err <= tol * scale, (path, err, scale)


def _cfgs(arch, **kw):
    return (dataclasses.replace(JC.get_smoke(arch), **kw),
            dataclasses.replace(PC.get_smoke(arch), **kw))


def _batch(cfg):
    return JCorpus(vocab=cfg.vocab, seq_len=L, global_batch=B, seed=3,
                   n_codebooks=cfg.n_codebooks).batch(5)


@pytest.fixture(scope="module")
def first_step():
    """Per (arch, variant): repro's params, batch, loss and grads, built
    once per module (one jitted ``value_and_grad`` each)."""
    cache = {}

    def get(arch, want_fn=False, **kw):
        key = (arch, tuple(sorted(kw.items())))
        if key not in cache:
            jcfg, pcfg = _cfgs(arch, **kw)
            params = JM.init_params(JM.param_specs(jcfg),
                                    jax.random.PRNGKey(11))
            batch = _batch(jcfg)
            vg = jax.jit(jax.value_and_grad(JM.make_loss_fn(jcfg)))
            jb = {k: jnp.asarray(v) for k, v in batch.items()}
            loss, grads = vg(params, jb)
            cache[key] = (jcfg, pcfg, params, batch, float(loss), grads,
                          lambda p: vg(p, jb)[1])
        return cache[key][:6] if not want_fn else cache[key]
    return get


# --------------------------------------------------------------- data
@pytest.mark.parametrize("K,hosts", [(1, 1), (4, 1), (1, 2)])
def test_synthetic_corpus_bitwise(K, hosts):
    kw = dict(vocab=997, seq_len=40, global_batch=6, seed=7, n_codebooks=K,
              host_count=hosts, host_index=hosts - 1)
    for step in (0, 1, 2**20 + 3):
        want, got = JCorpus(**kw).batch(step), PCorpus(**kw).batch(step)
        assert want.keys() == got.keys()
        for k in want:
            assert want[k].dtype == got[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_sensor_updates_bitwise():
    j, p = JSensor(300, channels=3, seed=4), PSensor(300, channels=3, seed=4)
    for t in (0, 1, 977):
        np.testing.assert_array_equal(p.updates(t), j.updates(t))


# --------------------------------------------------------------- optim
def test_cosine_schedule_across_warmup_and_floor():
    kw = dict(peak_lr=3e-3, warmup=7, total=40, floor_frac=0.1)
    steps = np.arange(0, 60, dtype=np.int32)
    want = np.array([np.asarray(JO.cosine_schedule(jnp.asarray(s), **kw))
                     for s in steps])
    got = np.array([PO.cosine_schedule(torch.tensor(s), **kw).item()
                    for s in steps], np.float32)
    assert got[0] == 0.0 and got[7] == np.float32(3e-3)
    assert got[-1] == np.float32(3e-3 * 0.1) == want[-1]
    np.testing.assert_array_equal(got[:8], want[:8])       # the warmup
    # XLA's float32 cos and torch's differ by an ulp at some angles, which
    # the decay's 1 + cos(pi t) can double
    np.testing.assert_array_max_ulp(got, want, maxulp=2)


def _ulps_of_max(got, want):
    """The largest difference of two trees, per leaf in units of the
    spacing of float32 at the leaf's max |want|."""
    w = _np(want)
    return max(float(np.max(np.abs(t - w[p])) / np.spacing(np.max(np.abs(w[p]))))
               for p, t in _torch_np(got).items())


def test_adamw_update_on_repro_grads(first_step):
    """Two updates of the gemma3-1b SMOKE tree fed ``repro``'s own
    gradients.  The first, scaled to a global norm of 0.5 (clip scale
    exactly 1): the moments bitwise and the parameters within 2 ulp of
    each leaf's max (p - lr (step + decay p) cancels near zero, and XLA
    and torch divide by a scalar through its reciprocal in their own
    ways); the decay of stacked vectors is part of it.  The second, times
    40 on the moments the first left (clipped): the norm within 4 ulp
    (each leaf's sum of squares runs in another order than XLA's), and
    everything after the clip scale's last bits within 8 ulp of each
    leaf's max."""
    _, _, params, _, _, grads = first_step("gemma3-1b")
    norm = float(JO.global_norm(grads))
    jst = JO.adamw_init(params)
    pst = PO.adamw_init(params_from_numpy(jax.tree.map(np.asarray, params)))
    jp, pp = params, params_from_numpy(jax.tree.map(np.asarray, params))
    jup = jax.jit(JO.adamw_update)
    for i, mult in enumerate((0.5 / norm, 40.0)):
        g = jax.tree.map(lambda x: x * np.float32(mult), grads)
        jp, jst, jm = jup(g, jst, jp, jnp.asarray(1e-2, jnp.float32))
        pp, pst, pm = PO.adamw_update(
            params_from_numpy(jax.tree.map(np.asarray, g)), pst, pp,
            torch.tensor(1e-2))
        for k in ("grad_norm", "clip_scale"):
            np.testing.assert_array_max_ulp(pm[k].numpy(), np.asarray(jm[k]),
                                            maxulp=4)
        assert int(pst.count) == int(jst.count) == i + 1
        assert (float(pm["clip_scale"]) == 1.0) == (i == 0)
        if i == 0:
            for got, want in ((pst.mu, jst.mu), (pst.nu, jst.nu)):
                w = _np(want)
                for path, t in _torch_np(got).items():
                    np.testing.assert_array_equal(t, w[path], str(path))
            assert _ulps_of_max(pp, jp) <= 2
        else:
            for got, want in ((pp, jp), (pst.mu, jst.mu), (pst.nu, jst.nu)):
                assert _ulps_of_max(got, want) <= 8
    assert float(pm["clip_scale"]) < 1.0
    # the decay rule: a third step without weight decay moves a stacked
    # norm gamma (2-D) differently and a prefix one (1-D) identically
    g = params_from_numpy(jax.tree.map(np.asarray, grads))
    lr = torch.tensor(1e-2)
    with_d, _, _ = PO.adamw_update(g, pst, pp, lr)
    without, _, _ = PO.adamw_update(g, pst, pp, lr, weight_decay=0.0)
    stacked = with_d["scan"]["s0"]["mixer"]["norm"]
    flat = with_d["prefix"]["l0"]["mixer"]["norm"]
    assert stacked.dim() == 2 and flat.dim() == 1
    assert not torch.equal(stacked, without["scan"]["s0"]["mixer"]["norm"])
    assert torch.equal(flat, without["prefix"]["l0"]["mixer"]["norm"])


def test_compressed_gradients_bitwise_with_ties():
    rng = np.random.default_rng(0)
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5],
                    np.float32)          # scale 1 + 1e-12 rounds to 1.0
    tree = {"a": ties.reshape(3, 3),
            "b": {"c": rng.standard_normal((5, 7)).astype(np.float32),
                  "d": np.zeros((4,), np.float32)}}
    err = {"a": np.zeros((3, 3), np.float32),
           "b": {"c": (rng.standard_normal((5, 7)) * 1e-3).astype(np.float32),
                 "d": np.full((4,), 1e-20, np.float32)}}
    wd, we = JO.compressed_gradients(
        jax.tree.map(jnp.asarray, tree),
        JO.CompressionState(jax.tree.map(jnp.asarray, err)))
    gd, ge = PO.compressed_gradients(params_from_numpy(tree),
                                     PO.CompressionState(params_from_numpy(err)))
    for got, want in ((gd, wd), (ge.error, we.error)):
        w = _np(want)
        for path, t in _torch_np(got).items():
            np.testing.assert_array_equal(t.view(np.int32),
                                          w[path].view(np.int32), str(path))
    np.testing.assert_array_equal(gd["a"].numpy().ravel(),
                                  [127, 0, 2, 2, -0, -2, -2, 126, -126])


# --------------------------------------------------------------- the step
def _check_grads(first_step, arch, **kw):
    jcfg, pcfg, params, batch, loss, grads, grads_at = first_step(
        arch, want_fn=True, **kw)
    got_loss, got = PM.make_grads_fn(pcfg)(
        params_from_numpy(jax.tree.map(np.asarray, params)),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got_loss), loss, rtol=TOL)
    want = _np(grads)
    if arch != "xlstm-1.3b":
        _close_per_leaf(_torch_np(got), want)
        return
    # xlstm-1.3b's SMOKE gradients sit on a float32 noise floor above
    # 1e-4: both packages stray up to ~1e-3 of a leaf's max from a float64
    # run of the port, and a one-ulp nudge of every parameter moves
    # repro's own gradients by as much.  Gate each leaf at the larger of
    # 1e-4 of its max and 8 times that nudge's effect.
    nudged = _np(grads_at(jax.tree.map(
        lambda x: jnp.nextafter(x, jnp.inf), params)))
    for path, g in _torch_np(got).items():
        w = want[path]
        floor = float(np.max(np.abs(nudged[path] - w)))
        limit = max(TOL * float(np.max(np.abs(w))), 8 * floor)
        assert float(np.max(np.abs(g - w))) <= limit, (path, floor)


@pytest.mark.parametrize("arch", ARCHS)
def test_first_step_loss_and_grads_match_repro(first_step, arch):
    _check_grads(first_step, arch)


def test_ssm_seq_variant_matches_repro(first_step):
    """``repro``'s custom-VJP sequential scan (chunk 16 of L 32, two
    chunks) against the port's adjoint recurrence."""
    _check_grads(first_step, "jamba-v0.1-52b", ssm_mode="seq")


def test_grad_accum_remat_train_step_matches_repro():
    """``make_train_step`` of both packages with ``grad_accum=2`` and
    ``remat=True`` (gemma3-1b's published training settings, at two
    micro-batches): the loss, the metrics and the updated parameters and
    moments."""
    jcfg, pcfg = _cfgs("gemma3-1b", grad_accum=2, remat=True)
    params = JM.init_params(JM.param_specs(jcfg), jax.random.PRNGKey(2))
    batch = _batch(jcfg)
    jp, jo, jm = jax.jit(JM.make_train_step(jcfg))(
        params, JO.adamw_init(params),
        {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.asarray(0, jnp.int32))
    tp = params_from_numpy(jax.tree.map(np.asarray, params))
    pp, po, pm = PM.make_train_step(pcfg)(
        tp, PO.adamw_init(tp), {k: torch.from_numpy(v)
                                for k, v in batch.items()},
        torch.tensor(0, dtype=torch.int32))
    for k in ("loss", "grad_norm", "clip_scale"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=TOL)
    _close_per_leaf(_torch_np(pp), _np(jp))
    _close_per_leaf(_torch_np(po.mu), _np(jo.mu))
    # the first step must have moved the parameters
    assert any(np.any(a != b) for a, b in zip(_torch_np(pp).values(),
                                              _np(params).values()))


# --------------------------------------------------------------- trainers
TINY_KW = dict(n_layers=2, d_model=64, d_ff=128, vocab=128)


def _tiny():
    return _cfgs("minitron-8b", **TINY_KW)


def _tc(cls, **kw):
    return cls(**{**dict(steps=3, seq_len=16, global_batch=4, peak_lr=1e-2,
                         warmup=1, log_every=100), **kw})


def _repro_state(trainer):
    return jax.tree.map(np.asarray, trainer.init_state())


@pytest.mark.parametrize("compress", [False, True])
def test_three_step_trajectory_matches_repro(compress):
    jcfg, pcfg = _tiny()
    jt = JTrainer(jcfg, _tc(JTrainConfig, compress_grads=compress),
                  log=lambda *_: None)
    state = _repro_state(jt)
    want = jt.run(state=jax.tree.map(jnp.asarray, state))
    pt = Trainer(pcfg, _tc(TrainConfig, compress_grads=compress),
                 log=lambda *_: None, device="cpu")
    got = pt.run(state=train_state_from_numpy(state))
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([m[key] for m in got["history"]],
                                   [m[key] for m in want["history"]],
                                   rtol=TOL)
    assert [m["step"] for m in got["history"]] == [0, 1, 2]
    assert got["final_step"] == 3 and int(got["state"]["step"]) == 3
    host = train_state_to_numpy(got["state"])
    assert int(host["opt"].count) == 3
    assert (host["comp"] is not None) == compress


@pytest.mark.parametrize("first", ["repro", "port"])
def test_checkpoint_resumes_across_packages(tmp_path, first):
    """Two steps by one package's trainer into ``ckpt_dir``, then the
    other package's trainer restores step 2 and runs steps 2-3; its losses
    equal a straight four-step run of the first package at the tolerance
    of ``tests/test_training_serving.py``'s resume test."""
    jcfg, pcfg = _tiny()
    ck = str(tmp_path / "ck")

    def make(pkg, steps, ckpt_dir):
        if pkg == "repro":
            return JTrainer(jcfg, _tc(JTrainConfig, steps=steps,
                                      ckpt_dir=ckpt_dir, ckpt_every=100),
                            log=lambda *_: None)
        return Trainer(pcfg, _tc(TrainConfig, steps=steps, ckpt_dir=ckpt_dir,
                                 ckpt_every=100),
                       log=lambda *_: None, device="cpu")

    def start(pkg, state):
        return (jax.tree.map(jnp.asarray, state) if pkg == "repro"
                else train_state_from_numpy(state))

    state = _repro_state(make("repro", 4, None))
    second = "port" if first == "repro" else "repro"
    out1 = make(first, 2, ck).run(state=start(first, state))
    assert out1["final_step"] == 2
    out2 = make(second, 4, ck).run(state=start(second, state))
    assert out2["final_step"] == 4
    assert [m["step"] for m in out2["history"]] == [2, 3]
    straight = make(first, 4, None).run(state=start(first, state))
    np.testing.assert_allclose([m["loss"] for m in out2["history"]],
                               [m["loss"] for m in straight["history"][2:]],
                               rtol=1e-4, atol=1e-5)


def test_train_launcher_on_the_cpu(capsys):
    out = train_main(["--arch", "gemma3-1b", "--smoke", "--device", "cpu",
                      "--steps", "2", "--batch", "2", "--seq", "16"])
    assert out["final_step"] == 2
    assert all(np.isfinite(m["loss"]) for m in out["history"])
    assert "final loss" in capsys.readouterr().out


def test_trainer_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(_tiny()[1], _tc(TrainConfig))
