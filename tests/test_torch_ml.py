"""The port's copy of the ML lifecycle (`codegraph_tpu_torch/ml/`) held to
the JAX package's `ml/` on the CPU.

Each case of tests/test_ml.py runs on the same inputs through both
packages: experiment assignments, statistics and reports, drift reports,
code features and the retrain pipeline's events must be equal (the
modules are copies; numpy does the arithmetic on both sides).

Then the slice as a whole: an MLLifecycle whose drift trigger retrains an
encoder (the small config of test_torch_training, weights carried from
JAX, three f32 steps of each package's train_step), saves it with each
package's save_encoder_checkpoint and registers it with load_model as an
EncoderProvider. The two retrained providers' embeddings of the same
texts agree within 5e-3: the providers run the bf16 forward, which holds
to JAX's compiled forward within that bound at hidden 64
(test_torch_encoder's BF16_TOL_SMALL); the f32 retrains themselves agree
to ~1e-5 (test_torch_training).
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codegraph_tpu.core import types as jtypes
from codegraph_tpu.ml import ab_testing as jab
from codegraph_tpu.ml import drift as jdrift
from codegraph_tpu.ml import features as jfeat
from codegraph_tpu.ml import pipeline as jpipe
from codegraph_tpu.models import providers as jprov
from codegraph_tpu.models import training as jt
from codegraph_tpu_torch.core import types as ttypes
from codegraph_tpu_torch.ml import ab_testing as tab
from codegraph_tpu_torch.ml import drift as tdrift
from codegraph_tpu_torch.ml import features as tfeat
from codegraph_tpu_torch.ml import pipeline as tpipe
from codegraph_tpu_torch.models import providers as tprov
from codegraph_tpu_torch.models import training as tt
from codegraph_tpu_torch.models.encoder import encoder_params_from_jax

from tests.test_torch_encoder import numpy_params
from tests.test_torch_training import configs, pair_batch

EMB_TOL = 5e-3
TEXTS = ["def load(path): return open(path).read()", "class Graph: pass",
         "for x in xs:\n    total += x", "import numpy as np"]


def _same(a, b):
    """Equal reports: dataclasses, dicts, sequences, floats bit for bit."""
    if dataclasses.is_dataclass(a):
        return type(a).__name__ == type(b).__name__ and _same(dataclasses.asdict(a),
                                                              dataclasses.asdict(b))
    if isinstance(a, dict):
        return set(a) == set(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, (float, np.floating)) and np.isnan(a):
        return bool(np.isnan(b))
    return a == b


def test_ab_assignment_equal():
    got = []
    for mod in (jab, tab):
        fw = mod.ABTestingFramework()
        fw.create("rerank_onoff", ["control", "treatment"], [0.5, 0.5])
        got.append([fw.assign("rerank_onoff", f"user{i}") for i in range(400)])
    assert got[0] == got[1]
    assert 0.35 < got[1].count("treatment") / 400 < 0.65


def _ab_run(mod, means, n, seed):
    rng = np.random.default_rng(seed)
    exp = mod.ABTestingFramework().create("latency", ["a", "b"], min_samples=30)
    for _ in range(n):
        exp.record("a", rng.normal(means[0], 5))
        exp.record("b", rng.normal(means[1], 5))
    return {"welch": exp.welch_t("a", "b"), "mw": exp.mann_whitney("a", "b"),
            "boot": exp.bootstrap_diff("a", "b", n_boot=200),
            "stop": exp.check_early_stop(lower_is_better=True), "report": exp.report()}


@pytest.mark.parametrize("means,n", [((100, 80), 100), ((100, 100), 50)])
def test_ab_statistics_and_reports_equal(means, n):
    j, t = _ab_run(jab, means, n, 0), _ab_run(tab, means, n, 0)
    assert _same(j, t)
    if means[0] != means[1]:
        assert t["report"]["winner"] == "b" and t["welch"][1] < 0.01


def test_mann_whitney_midranks_equal():
    out = []
    for mod in (jab, tab):
        t = mod.ABExperiment("exp", arms=["a", "b"], traffic=[0.5, 0.5])
        for v in [1.0, 1.0, 2.0, 2.0, 2.0, 3.0]:
            t.record("a", v)
            t.record("b", v)
        out.append(t.mann_whitney("a", "b"))
    assert _same(out[0], out[1]) and abs(out[1][0] - 18.0) < 1e-9


def test_drift_reports_equal(rng):
    ref = rng.standard_normal((2000, 32)).astype(np.float32)
    same = rng.standard_normal((500, 32)).astype(np.float32)
    reports = []
    for mod in (jdrift, tdrift):
        det = mod.DriftDetector(ref)
        reports.append((det.check(same), det.check(same + 3.0)))
    assert _same(reports[0], reports[1])
    assert not reports[1][0].drifted and reports[1][1].drifted


def test_code_features_equal():
    feats = []
    for types, mod in ((jtypes, jfeat), (ttypes, tfeat)):
        node = types.CodeNode.make(
            "p", "compute_total", types.NodeType.FUNCTION, types.Language.PYTHON,
            types.Location("a.py", 1, 6),
            content="def compute_total(xs):\n    # sum them\n    t = 0\n"
                    "    for x in xs:\n        if x > 0:\n            t += x\n"
                    "    return t",
            complexity=3,
        )
        node.metadata["references"] = 4
        feats.append(mod.extract_code_features(node))
    assert feats[0] == feats[1]
    assert feats[1]["n_lines"] == 7 and feats[1]["cyclomatic"] == 3


def _pipeline_run(mod, drift_mod, seed, fail=False):
    rng = np.random.default_rng(seed)
    ref = rng.standard_normal((2000, 32)).astype(np.float32)
    calls, clock = [], [0.0]

    def retrain(samples):
        calls.append((len(samples), float(samples.sum())))
        return not fail

    pipe = mod.MLPipeline(ref, retrain_fn=retrain,
                          policy=mod.RetrainPolicy(consecutive_drifted=3, cooldown_s=10.0,
                                                   min_samples=500),
                          clock=lambda: clock[0])
    reports = [pipe.observe(rng.standard_normal((256, 32)).astype(np.float32)) for _ in range(3)]
    reports += [pipe.observe((rng.standard_normal((256, 32)) + 4.0).astype(np.float32))
                for _ in range(4)]
    reports += [pipe.observe((rng.standard_normal((256, 32)) - 6.0).astype(np.float32))
                for _ in range(4)]
    clock[0] = 100.0
    reports.append(pipe.observe((rng.standard_normal((256, 32)) - 6.0).astype(np.float32)))
    events = [(e.n_samples, e.succeeded, e.detail, [dataclasses.asdict(r) for r in e.reports])
              for e in pipe.events]
    return calls, [dataclasses.asdict(r) for r in reports], events, pipe.stats()


@pytest.mark.parametrize("fail", [False, True])
def test_pipeline_retrain_trigger_equal(fail):
    j = _pipeline_run(jpipe, jdrift, 5, fail)
    t = _pipeline_run(tpipe, tdrift, 5, fail)
    assert _same(j, t)
    assert t[3]["retrains"] >= 1 and t[0][0][0] == 768


def test_lifecycle_facade_equal():
    outs = []
    for pipe, prov in ((jpipe, jprov), (tpipe, tprov)):
        life = pipe.MLLifecycle() if pipe is jpipe else pipe.MLLifecycle(device="cpu")
        life.register_model("a", prov.HashProvider(32))
        life.register_model("b", prov.HashProvider(64))
        arm, emb = (life.start_ab_test("exp", ["a", "b"]),
                    life.predict_with_ab_test("exp", "user-1", ["q"]))[1]
        life.record_ab("exp", arm, 0.5)
        life.pause()
        with pytest.raises(RuntimeError):
            life.predict("a", "x")
        life.resume()
        life.train_model("c", lambda: prov.HashProvider(16))
        with pytest.raises(ValueError):
            life.train_model("d", lambda: (_ for _ in ()).throw(ValueError("x")))
        outs.append({"a": life.predict("a", "def f(): pass"),
                     "b": life.predict_batch("b", ["x", "y"]), "arm": arm, "emb": emb,
                     "report": life.analyze_ab_test("exp"), "status": life.get_status().value,
                     "context": life.get_context(), "c": life.predict("c", "x")})
    j, t = outs
    for k in ("a", "b", "emb", "c"):
        np.testing.assert_array_equal(t[k], j[k])
    assert _same({k: j[k] for k in ("arm", "report", "status", "context")},
                 {k: t[k] for k in ("arm", "report", "status", "context")})
    assert t["status"] == "error" and "ValueError" in t["context"]["error"]


def test_lifecycle_drift_retrain_equal():
    calls = []
    for pipe in (jpipe, tpipe):
        rng = np.random.default_rng(0)
        got = []
        kw = {} if pipe is jpipe else {"device": "cpu"}
        life = pipe.MLLifecycle(
            drift_reference=rng.standard_normal((512, 16)).astype(np.float32),
            retrain_fn=lambda s, got=got: (got.append(len(s)), True)[1],
            policy=pipe.RetrainPolicy(consecutive_drifted=2, cooldown_s=0.0, min_samples=64),
            **kw)
        for _ in range(3):
            life.observe(rng.standard_normal((128, 16)).astype(np.float32) + 4.0)
        calls.append((got, life.get_context()["drift"]))
    assert calls[0] == calls[1] and calls[1][0]


def test_lifecycle_model_save_load_across_packages(tmp_path):
    """The port saves a registered encoder, loads it back on the CPU, and
    the JAX package loads the same file: equal embeddings."""
    life = tpipe.MLLifecycle(device="cpu")
    life.register_model("enc", tprov.EncoderProvider(dimension=64, max_len=32, device="cpu"))
    path = str(tmp_path / "enc.npz")
    life.save_model("enc", path)
    life.load_model("enc2", path)
    a = life.predict_batch("enc", TEXTS)
    np.testing.assert_array_equal(life.predict_batch("enc2", TEXTS), a)
    jlife = jpipe.MLLifecycle()
    jlife.load_model("enc", path)
    np.testing.assert_allclose(jlife.predict_batch("enc", TEXTS), a, rtol=0, atol=EMB_TOL)


def test_lifecycle_load_model_asks_for_cuda_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    life = tpipe.MLLifecycle(device="cpu")
    life.register_model("enc", tprov.EncoderProvider(dimension=64, max_len=32, device="cpu"))
    path = str(tmp_path / "enc.npz")
    life.save_model("enc", path)
    with pytest.raises(RuntimeError, match="cuda"):
        tpipe.MLLifecycle().load_model("enc", path)


# -- the slice: drift -> retrain -> checkpoint -> registered provider --------


def _retrain_jax(tree, path):
    jcfg, _ = configs("f32")
    tc = jt.TrainConfig(learning_rate=1e-3)
    opt = jt.make_optimizer(tc)
    step = jax.jit(partial(jt.train_step, cfg=jcfg, tcfg=tc, optimizer=opt))
    p = jax.tree.map(jnp.asarray, tree)
    s = opt.init(p)
    for i in range(3):
        p, s, m = step(p, s, {k: jnp.asarray(v) for k, v in pair_batch(i).items()})
    jprov.save_encoder_checkpoint(path, jax.tree.map(np.asarray, p), cfg=jcfg)
    return float(m["loss"])


def _retrain_port(tree, path):
    _, tcfg = configs("f32")
    ttc = tt.TrainConfig(learning_rate=1e-3)
    opt = tt.make_optimizer(ttc)
    p = encoder_params_from_jax(tree)
    s = opt.init(p)
    for i in range(3):
        p, s, m = tt.train_step(p, s, pair_batch(i), tcfg, ttc, opt)
    tprov.save_encoder_checkpoint(path, p, cfg=tcfg)
    return float(m["loss"])


def test_drift_triggered_retrain_registers_provider_like_jax(tmp_path):
    tree = numpy_params(configs("f32")[0])
    out = {}
    for name, pipe, retrain in (("jax", jpipe, _retrain_jax), ("port", tpipe, _retrain_port)):
        rng = np.random.default_rng(11)
        kw = {} if name == "jax" else {"device": "cpu"}
        path = str(tmp_path / f"{name}.npz")
        losses = []
        life = None

        def retrain_fn(samples, path=path, losses=losses, retrain=retrain):
            losses.append(retrain(tree, path))
            life.load_model("retrained", path)
            return True

        life = pipe.MLLifecycle(
            drift_reference=rng.standard_normal((512, 16)).astype(np.float32),
            retrain_fn=retrain_fn,
            policy=pipe.RetrainPolicy(consecutive_drifted=2, cooldown_s=0.0, min_samples=64),
            **kw)
        for _ in range(2):
            life.observe(rng.standard_normal((128, 16)).astype(np.float32) + 4.0)
        assert life.get_context()["drift"]["retrains"] == 1 and len(losses) == 1
        assert life.get_status().value == "ready"
        prov = life.models["retrained"]
        assert type(prov).__name__ == "EncoderProvider" and prov.cfg.n_heads == 4
        out[name] = (losses[0], life.predict_batch("retrained", TEXTS))
    assert abs(out["port"][0] - out["jax"][0]) <= 1e-5 * abs(out["jax"][0])
    np.testing.assert_allclose(out["port"][1], out["jax"][1], rtol=0, atol=EMB_TOL)
    assert out["port"][1].shape == (len(TEXTS), 64)
