"""The port's training path (``repro_torch.training``, ``repro_torch.data``,
``repro_torch.launch.train``, bf16 checkpoints) against the JAX reference
on the CPU.

Weights are drawn by the port's ``init_params`` and go into the reference
as ``jnp`` arrays and into the port through ``params_from_jax``; optimizer
state crosses with ``opt_state_from_jax``. Tolerances:
  - AdamW and Adafactor on one tree (hymba's smoke parameters: norm scales
    stacked ``(2, d)`` and alone ``(d,)``, scalars, a ``(5, d)`` leaf,
    the groups of one layer in bfloat16, the rest float32), 3 steps on the
    same float32 gradients: parameters and state within rtol 1e-6 / atol
    1e-7 (float32 elementwise arithmetic op for op; Adafactor's means sum
    in another order), a bfloat16 parameter within one bfloat16 ulp;
  - ``cosine_schedule``: bitwise wherever XLA:CPU's float32 cos is
    correctly rounded; elsewhere within ``base_lr`` times 2**-23 (the
    port's cos is math.cos rounded to float32: ``optimizer.py``);
  - ``global_norm`` and ``clip_by_global_norm`` within rtol 1e-6 (one
    float32 sum of squares a leaf, summed in the reference's leaf order);
  - ``make_train_step`` over 3 steps on the same ``TokenPipeline``
    batches at lr 1e-3: the loss within rtol 1e-5, ``grad_norm`` within
    rtol 5e-4 (hymba's parts by up to 7.6e-5 after an update: its
    gradient sits in fusion scalars that cancel, see
    ``test_torch_lm_grads.py``), every parameter within 0.2 lr (plus
    rtol 1e-5), and beyond atol 1e-6 / rtol 1e-5 at most 0.1% of all
    elements and, in a leaf, 3 or 1% of its elements: Adam's update of
    an element whose gradient is within a few ``eps`` (1e-8) of 0 moves
    with the gradient's last bits, up to 0.05 lr at hymba's (measured
    before this file: at most 0.064% of the elements, hymba's at step 3;
    2 of the 96 K biases of qwen's); the rest agree to float32 rounding;
  - ``TokenPipeline``, checkpoints and the trainer's restart: bitwise.
The train step of hymba and arctic, the two heaviest smoke configs, is
marked ``slow`` as the reference's ``test_models_smoke.py`` marks them;
their loss and gradients are held in ``test_torch_lm_grads.py``.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jx_configs  # noqa: E402
from repro.data.pipeline import TokenPipeline as JxPipeline  # noqa: E402
from repro.ft.checkpoint import CheckpointManager as JxManager  # noqa: E402
from repro.training import optimizer as jx_opt  # noqa: E402
from repro.training import train_loop as jx_loop  # noqa: E402
from repro_torch import configs as pt_configs  # noqa: E402
from repro_torch.data.pipeline import TokenPipeline as PtPipeline  # noqa: E402
from repro_torch.ft.checkpoint import CheckpointManager as PtManager  # noqa: E402
from repro_torch.models import params as pt_params  # noqa: E402
from repro_torch.training import optimizer as pt_opt  # noqa: E402
from repro_torch.training import train_loop as pt_loop  # noqa: E402

B, S = 2, 16
LR = 1e-3
_HEAVY = {"hymba-1.5b", "arctic-480b"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These shapes are small: one intra-op thread is faster than the
    default pool when the test workers share the machine, and leaves the
    cores to them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _paths(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf for path, leaf in flat}


def _weights(cfg, seed=0):
    """(host tree of float32 numpy arrays, the port's params)."""
    drawn = pt_params.init_params(
        cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
    host = pt_params.tree_map(lambda t: t.float().numpy(), drawn)
    return host, pt_params.params_from_jax(cfg, host, device="cpu")


def _hold_tree(got, want, what, rtol, atol):
    want = _paths(want)
    got = dict(pt_params.tree_leaves(got))
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want))[:4])
    for path, w in want.items():
        assert tuple(got[path].shape) == tuple(w.shape), (what, path)
        np.testing.assert_allclose(_np(got[path]), _np(w), rtol=rtol,
                                   atol=atol, err_msg=f"{what}: {path}")


# ---------------------------------------------------------------- optimizers
def _mixed_tree():
    """hymba's smoke parameters, the groups of one layer in bfloat16.

    Each package gets buffers of its own: ``jnp.asarray`` may take an
    aligned numpy array without a copy, and the port's optimizers write
    their parameters in place, so one shared buffer would let the port's
    update reach the reference's parameters while its asynchronously
    dispatched update still reads them."""
    cfg = pt_configs.get_smoke("hymba-1.5b")
    host, _ = _weights(cfg, seed=3)
    plan = cfg.layer_plan()
    jx_tree = jax.tree.map(jnp.asarray, host)
    pt_tree = pt_params.tree_map(lambda a: torch.from_numpy(a.copy()), host)
    for gi, (_, repeat) in enumerate(plan):
        if repeat == 1:
            jx_tree["groups"][gi] = jax.tree.map(
                lambda a: a.astype(jnp.bfloat16), jx_tree["groups"][gi])
            pt_tree["groups"][gi] = pt_params.tree_map(
                lambda t: t.bfloat16(), pt_tree["groups"][gi])
    return cfg, jx_tree, pt_tree


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_matches_reference_on_stacked_and_single_leaves(name):
    cfg, jp, pp = _mixed_tree()
    shapes = {p: tuple(t.shape) for p, t in pt_params.tree_leaves(pp)}
    # the stacked and the lone norm scales both present
    assert shapes["groups.1.sub0.ln1"] == (2, cfg.d_model)
    assert shapes["groups.0.sub0.ln1"] == (cfg.d_model,)
    assert pp["groups"][0]["sub0"]["ln1"].dtype == torch.bfloat16
    jo, po = getattr(jx_opt, name)(), getattr(pt_opt, name)()
    js = jo.init(jp)
    ps = pt_params.opt_state_from_jax(cfg, jax.tree.map(np.asarray, js),
                                      device="cpu")
    _hold_tree(ps, po.init(pp), "init", 0, 0)
    if name == "adafactor":  # factored on the stacked leaf alone
        assert set(ps["v"]["groups"][1]["sub0"]["ln1"]) == {"vr", "vc"}
        assert set(ps["v"]["groups"][0]["sub0"]["ln1"]) == {"v"}
    rng = np.random.default_rng(4)
    jx_update = jax.jit(jo.update)
    for step in range(3):
        grads = {p: rng.normal(size=s).astype(np.float32) * 0.01
                 for p, s in shapes.items()}
        it = iter(grads[p] for p, _ in pt_params.tree_leaves(pp))
        pg = pt_params.tree_map(
            lambda _: torch.from_numpy(np.array(next(it))), pp)
        jg = jax.tree.map(jnp.asarray, pt_params.tree_map(_np, pg))
        jp, js = jx_update(jg, js, jp, jnp.float32(LR))
        out_p, out_s = po.update(pg, ps, pp, torch.tensor(LR))
        assert out_p is pp and out_s is ps  # in place
        assert int(ps["step"]) == int(js["step"]) == step + 1
        _hold_tree(ps, jax.tree.map(np.asarray, js), f"state {step}",
                   1e-6, 1e-7)
        want = _paths(jp)
        for path, t in pt_params.tree_leaves(pp):
            w = want[path]
            assert t.dtype == (torch.bfloat16 if w.dtype == jnp.bfloat16
                               else torch.float32), path
            rtol = 2.0 ** -8 if t.dtype == torch.bfloat16 else 1e-6
            np.testing.assert_allclose(_np(t), _np(w), rtol=rtol, atol=1e-7,
                                       err_msg=f"step {step}: {path}")


def test_weight_decay_and_factoring_follow_the_stacked_ndim():
    """A norm scale of ones under zero gradients: AdamW decays the stacked
    (2, d) copy, not the lone (d,) one; Adafactor factors the stacked one."""
    tree = {"solo": torch.ones(8), "stacked": torch.ones(2, 8)}
    grads = {k: torch.zeros_like(v) for k, v in tree.items()}
    opt = pt_opt.adamw()
    state = opt.init(tree)
    opt.update(grads, state, tree, torch.tensor(LR))
    assert torch.equal(tree["solo"], torch.ones(8))
    assert bool((tree["stacked"] < 1).all())
    af = pt_opt.adafactor().init(tree)
    assert set(af["v"]["stacked"]) == {"vr", "vc"}
    assert tuple(af["v"]["stacked"]["vc"].shape) == (8,)
    assert set(af["v"]["solo"]) == {"v"}


def test_adafactor_gives_the_reference_nan_on_an_all_zero_factored_leaf():
    """A property of the reference kept: with eps = 1e-30 an all-zero
    gradient gives vr = vc = 1e-30, whose float32 product underflows to 0,
    so the update is 0 / 0 in both packages."""
    p = np.ones((3, 4), np.float32)
    jp, js = jx_opt.adafactor().update(
        {"w": jnp.zeros((3, 4))}, jx_opt.adafactor().init({"w": jnp.asarray(p)}),
        {"w": jnp.asarray(p)}, jnp.float32(LR))
    tree = {"w": torch.from_numpy(p.copy())}
    opt = pt_opt.adafactor()
    opt.update({"w": torch.zeros(3, 4)}, opt.init(tree), tree,
               torch.tensor(LR))
    assert np.isnan(np.asarray(jp["w"])).all()
    assert bool(torch.isnan(tree["w"]).all())


def test_cosine_schedule_matches_reference():
    n_off = 0
    for base, warmup, total in [(3e-4, 5, 50), (1e-3, 1, 8), (0.1, 0, 3),
                                (2e-4, 10, 1000)]:
        jx_lr = jx_opt.cosine_schedule(base, warmup, total)
        pt_lr = pt_opt.cosine_schedule(base, warmup, total)
        for step in range(total + 2):
            got = pt_lr(step)
            assert got.dtype == torch.float32 and got.device.type == "cpu"
            want = np.float32(jx_lr(step))
            # the cos XLA:CPU took, against the correctly rounded one
            prog = np.float32(np.clip((np.float32(step) - warmup)
                                      / np.float32(max(total - warmup, 1)),
                                      0, 1))
            arg = jnp.float32(jnp.pi) * jnp.float32(prog)
            xla_cos = np.float32(jnp.cos(arg))
            exact_cos = np.float32(np.cos(np.float64(np.float32(arg))))
            if step < warmup or xla_cos == exact_cos:
                assert got.numpy().tobytes() == want.tobytes(), \
                    (base, warmup, total, step)
            else:
                n_off += 1
                assert abs(float(got) - float(want)) <= base * 2.0 ** -23
    assert n_off < 100


def test_global_norm_and_clip_match_reference():
    rng = np.random.default_rng(5)
    host = {"b": [rng.normal(size=(7, 3)).astype(np.float32),
                  {"z": rng.normal(size=(5,)).astype(np.float32)}],
            "a": rng.normal(size=(4, 4)).astype(np.float32) * 3}
    jt = jax.tree.map(jnp.asarray, host)
    pt = pt_params.tree_map(torch.from_numpy, host)
    pt["b"][0] = pt["b"][0].bfloat16()
    jt["b"][0] = jt["b"][0].astype(jnp.bfloat16)
    np.testing.assert_allclose(float(pt_loop.global_norm(pt)),
                               float(jx_loop.global_norm(jt)), rtol=1e-6)
    for max_norm in (1.0, 1e3):  # scaled, then left alone
        (got, gn) = pt_loop.clip_by_global_norm(pt, max_norm)
        (want, wn) = jx_loop.clip_by_global_norm(jt, max_norm)
        np.testing.assert_allclose(float(gn), float(wn), rtol=1e-6)
        _hold_tree(got, want, f"clip {max_norm}", 1e-6, 1e-7)
        if max_norm > float(gn):
            assert torch.equal(got["a"], pt["a"])


# ------------------------------------------------------------ the train step
_STEP_CASES = (
    [pytest.param(a, "adamw", 2, marks=pytest.mark.slow) if a in _HEAVY
     else (a, "adamw", 2) for a in jx_configs.names()]
    + [("qwen2.5-3b", "adamw", 1), ("qwen2.5-3b", "adafactor", 1),
       ("qwen2.5-3b", "adafactor", 2), ("gemma2-2b", "adafactor", 2)])


def _step_batches(cfg, accum, n_steps):
    pipe = JxPipeline(vocab=cfg.vocab, seq_len=S, global_batch=B * accum,
                      seed=0, over_factor=1)
    rng = np.random.default_rng(6)
    out = []
    for _ in range(n_steps):
        toks, labels = pipe.next_batch()
        b = {"tokens": toks.reshape(accum, B, S),
             "labels": labels.reshape(accum, B, S)}
        if cfg.cross_attn:
            b["ctx"] = rng.normal(size=(accum, B, cfg.cross_attn.n_ctx,
                                        cfg.d_model)).astype(np.float32)
        if cfg.enc_dec:
            b["enc"] = rng.normal(size=(accum, B, S, cfg.d_model)
                                  ).astype(np.float32)
        out.append(b)
    return out


def _hold_params_after_step(got, want, what):
    want = _paths(want)
    n_loose = n = 0
    for path, t in pt_params.tree_leaves(got):
        g, w = _np(t), _np(want[path])
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=0.2 * LR,
                                   err_msg=f"{what}: {path}")
        loose = int((np.abs(g - w) > 1e-6 + 1e-5 * np.abs(w)).sum())
        assert loose <= max(3, 0.01 * g.size), (what, path, loose, g.size)
        n_loose, n = n_loose + loose, n + g.size
    assert n_loose <= 1e-3 * n, (what, n_loose, n)


@pytest.mark.parametrize("arch,name,accum", _STEP_CASES)
def test_train_step_matches_reference(arch, name, accum):
    cfg = pt_configs.get_smoke(arch)
    host, pp = _weights(cfg)
    jp = jax.tree.map(jnp.asarray, host)
    jo, po = getattr(jx_opt, name)(), getattr(pt_opt, name)()
    js, ps = jo.init(jp), po.init(pp)
    jstep = jax.jit(jx_loop.make_train_step(jx_configs.get_smoke(arch), jo,
                                            accum=accum))
    pstep = pt_loop.make_train_step(cfg, po, accum=accum)
    for i, b in enumerate(_step_batches(cfg, accum, 3)):
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()},
                           jnp.float32(LR))
        pb = {k: torch.from_numpy(v).long() if v.dtype == np.int32
              else torch.from_numpy(v) for k, v in b.items()}
        pp, ps, pm = pstep(pp, ps, pb, torch.tensor(LR))
        assert pm["loss"].shape == () and pm["grad_norm"].shape == ()
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=5e-4)
        _hold_params_after_step(pp, jp, f"{arch} {name} step {i}")
    assert int(ps["step"]) == 3


def test_accum_two_of_the_same_microbatch_is_accum_one():
    """[x, x] at accum=2 averages two equal float32 gradients: the step
    equals accum=1 on x bit for bit (a sum of two equal values halves
    exactly)."""
    cfg = pt_configs.get_smoke("llama4-maverick-400b-a17b")
    b = _step_batches(cfg, 1, 1)[0]
    runs = []
    for accum in (1, 2):
        _, pp = _weights(cfg)
        opt = pt_opt.adamw()
        st = opt.init(pp)
        batch = {k: torch.from_numpy(np.concatenate([v] * accum)).long()
                 for k, v in b.items()}
        pp, st, m = pt_loop.make_train_step(cfg, opt, accum=accum)(
            pp, st, batch, torch.tensor(LR))
        runs.append((pp, m))
    (p1, m1), (p2, m2) = runs
    assert torch.equal(m1["loss"], m2["loss"])
    assert torch.equal(m1["grad_norm"], m2["grad_norm"])
    other = dict(pt_params.tree_leaves(p2))
    for path, t in pt_params.tree_leaves(p1):
        assert torch.equal(t, other[path]), path


def test_grad_transform_sees_the_float32_gradients():
    cfg = pt_configs.get_smoke("qwen2.5-3b")
    _, pp = _weights(cfg)
    opt = pt_opt.adamw()
    seen = []

    def zero(grads):
        seen.extend(g.dtype for _, g in pt_params.tree_leaves(grads))
        return pt_params.tree_map(torch.zeros_like, grads)

    b = _step_batches(cfg, 1, 1)[0]
    before = pt_params.tree_map(torch.clone, pp)
    _, _, m = pt_loop.make_train_step(cfg, opt, grad_transform=zero)(
        pp, opt.init(pp), {k: torch.from_numpy(v).long() for k, v in b.items()},
        torch.tensor(LR))
    assert seen and set(seen) == {torch.float32}
    assert float(m["grad_norm"]) == 0.0
    # zero gradients: AdamW moves only the decayed (ndim >= 2) leaves
    for path, t in pt_params.tree_leaves(pp):
        was = dict(pt_params.tree_leaves(before))[path]
        assert torch.equal(t, was) == (t.ndim < 2 or not bool(was.any())), \
            path


# -------------------------------------------------------------- the pipeline
def test_token_pipeline_is_the_reference_bit_for_bit():
    kw = dict(vocab=1000, seq_len=12, global_batch=24, seed=7, n_hosts=3,
              host_id=1, over_factor=4)
    jx, pt = JxPipeline(**kw), PtPipeline(**kw)
    assert pt.unit_count() == jx.unit_count() == 12
    for speeds in (None, [1.0, 0.25, 2.0], [3.0, 1.0, 1.0]):
        assert pt.assignments(speeds) == jx.assignments(speeds)
        a, b = pt.next_batch(speeds), jx.next_batch(speeds)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    for step in (0, 5, 123):
        assert np.array_equal(pt.global_batch_at(step), jx.global_batch_at(step))
    assert pt.state_dict() == jx.state_dict() == {"step": 3, "seed": 7}
    again = PtPipeline(**{**kw, "seed": 0})
    again.load_state_dict(json.loads(json.dumps(pt.state_dict())))
    assert np.array_equal(again.next_batch()[0], pt.next_batch()[0])


# --------------------------------------------------------------- the trainer
def _train(d, *extra):
    from repro_torch.launch import train as TR

    return TR.main(["--arch", "qwen2.5-3b", "--smoke", "--steps", "8",
                    "--batch", "2", "--seq", "16", "--accum", "1",
                    "--ckpt-every", "3", "--ckpt-dir", str(d),
                    "--device", "cpu", *extra])


def test_train_restart_equivalence(tmp_path):
    """Uninterrupted run == crash after step 5 + resume, bitwise on the
    loss (the reference's test asks rel 1e-6)."""
    loss_a = _train(tmp_path / "run_a")
    with pytest.raises(SystemExit) as e:
        _train(tmp_path / "run_b", "--simulate-failure", "5")
    assert e.value.code == 42
    assert PtManager(str(tmp_path / "run_b")).latest_step() == 2
    loss_b = _train(tmp_path / "run_b")
    assert loss_a == loss_b
    # the trainer's checkpoint keeps the reference's key paths
    with open(tmp_path / "run_a" / "step_0000000007" / "manifest.json") as f:
        keys = json.load(f)["keys"]
    assert {"0/embed", "1/m/embed", "1/v/embed", "1/step"} <= set(keys)


def test_trainer_needs_a_card_unless_cpu(monkeypatch, tmp_path):
    from repro_torch.launch import train as TR

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TR.main(["--smoke", "--steps", "1", "--ckpt-dir", str(tmp_path)])


# --------------------------------------------------------- bf16 checkpoints
def _bf16_tree(seed=8):
    x = np.random.default_rng(seed).normal(size=(3, 5)).astype(np.float32)
    return {"w": x, "n": np.arange(4, dtype=np.int32),
            "s": np.array(2.5, np.float32)}


def _stored(step_dir):
    """{key: (dtype, shape, data bytes)} of a step's shard."""
    with np.load(os.path.join(step_dir, "shard_0.npz")) as z:
        return {k: (z[k].dtype, z[k].shape, z[k].tobytes()) for k in z.files}


def test_bf16_leaf_has_the_reference_bytes_and_manifest(tmp_path):
    host = _bf16_tree()
    jx_tree = {"w": jnp.asarray(host["w"], jnp.bfloat16),
               "n": jnp.asarray(host["n"]), "s": jnp.asarray(host["s"])}
    pt_tree = {"w": torch.from_numpy(host["w"]).bfloat16(),
               "n": torch.from_numpy(host["n"]),
               "s": torch.from_numpy(host["s"])}
    JxManager(str(tmp_path / "jx")).save(1, jx_tree, {"k": 1})
    PtManager(str(tmp_path / "pt")).save(1, pt_tree, {"k": 1})
    man = {}
    for side in ("jx", "pt"):
        with open(tmp_path / side / "step_0000000001" / "manifest.json") as f:
            man[side] = json.load(f)
    assert man["pt"]["keys"] == man["jx"]["keys"]
    assert man["pt"]["keys"]["w"]["dtype"] == "bfloat16"
    # the same bits as the same 2-byte void type (the reference's npy
    # header spells it '<V2', ml_dtypes' name for it; numpy's own is '|V2')
    got = _stored(tmp_path / "pt" / "step_0000000001")
    assert got == _stored(tmp_path / "jx" / "step_0000000001")
    assert got["w"][0] == np.dtype("V2")


def test_reference_bf16_checkpoint_restores_into_the_port(tmp_path):
    host = _bf16_tree(9)
    w = jnp.asarray(host["w"], jnp.bfloat16)
    JxManager(str(tmp_path)).save(3, {"w": w, "n": jnp.asarray(host["n"])})
    target = {"w": torch.zeros(3, 5, dtype=torch.bfloat16),
              "n": torch.zeros(4, dtype=torch.int32)}
    got, _ = PtManager(str(tmp_path)).restore(target)
    assert got["w"].dtype == torch.bfloat16
    bits = np.asarray(w).view(np.int16)
    assert np.array_equal(got["w"].view(torch.int16).numpy(), bits)
    assert np.array_equal(got["n"].numpy(), host["n"])
    # into a float32 array target: the exact widening
    arr, _ = PtManager(str(tmp_path)).restore(
        {"w": np.zeros((3, 5), np.float32), "n": np.zeros(4, np.int64)})
    assert np.array_equal(arr["w"], np.asarray(w).astype(np.float32))
    # restore_blind hands back the stored bits
    blind, _ = PtManager(str(tmp_path)).restore_blind()
    assert blind["w"].dtype == np.dtype("V2")
    assert np.array_equal(blind["w"].view(np.int16), bits)


def test_reference_cannot_restore_its_own_bf16_checkpoint(tmp_path):
    """A property of the reference (``repro/ft/checkpoint.py``): its
    restore casts the stored ``|V2`` bits with ``astype``, which has no
    cast to bfloat16. If this starts passing, the port's reader is no
    longer the only one."""
    tree = {"w": jnp.ones((2, 2), jnp.bfloat16)}
    mgr = JxManager(str(tmp_path))
    mgr.save(0, tree)
    with pytest.raises(ValueError, match="cast"):
        mgr.restore(tree)


@pytest.mark.parametrize("use_async", [False, True])
def test_port_bf16_checkpoint_round_trips_bit_for_bit(tmp_path, use_async):
    cfg = dataclasses.replace(pt_configs.get_smoke("qwen2.5-3b"),
                              param_dtype="bfloat16")
    params = pt_params.init_params(
        cfg, generator=torch.Generator().manual_seed(2), device="cpu")
    opt = pt_opt.adamw()
    state = opt.init(params)
    state["step"].fill_(5)
    state["m"]["embed"].normal_()
    mgr = PtManager(str(tmp_path))
    save = mgr.save_async if use_async else mgr.save
    save(4, (params, state), {"step": 4})
    mgr.wait()
    target = (pt_params.tree_map(torch.zeros_like, params),
              opt.init(params))
    (got_p, got_s), extra = mgr.restore(target)
    assert extra == {"step": 4}
    for (path, a), (_, b) in zip(pt_params.tree_leaves(params),
                                 pt_params.tree_leaves(got_p)):
        assert b.dtype == torch.bfloat16 and torch.equal(
            a.view(torch.int16), b.view(torch.int16)), path
    for (path, a), (_, b) in zip(pt_params.tree_leaves(state),
                                 pt_params.tree_leaves(got_s)):
        assert a.dtype == b.dtype and torch.equal(a, b), path


def test_opt_state_from_jax_checks_the_tree(monkeypatch):
    cfg = pt_configs.get_smoke("qwen2.5-3b")
    host, pp = _weights(cfg)
    js = jax.tree.map(np.asarray, jx_opt.adamw().init(
        jax.tree.map(jnp.asarray, host)))
    ps = pt_params.opt_state_from_jax(cfg, js, device="cpu")
    assert ps["step"].dtype == torch.int32
    _hold_tree(ps, js, "adamw state", 0, 0)
    js["m"]["embed"] = js["m"]["embed"][:-1]
    with pytest.raises(ValueError, match="embed"):
        pt_params.opt_state_from_jax(cfg, js, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_params.opt_state_from_jax(cfg, js)

