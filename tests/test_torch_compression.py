"""repro_torch's wire codec (``optim/compression.py``) against the
reference's ``repro.optim.compression`` on the same arrays, and the
reference's own properties of the codec (tests/test_optim.py).

The two compute the same IEEE f32 arithmetic (a block's largest magnitude
over 127, a division, round half to even, a product), so every output is
held to the reference's bit for bit: tolerance 0.  The properties keep the
reference's bounds: |roundtrip - g| <= scale / 2 per block (relative slack
1e-6), error feedback within 1.5 quantization steps of the truth after 200
rounds where the naive codec drifts by 0.9 of the signal a round, and the
fed-back mean within rel 0.2 of the true mean.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.optim import compression as ref  # noqa: E402
from repro_torch.optim import compression  # noqa: E402


def _array(kind: str) -> np.ndarray:
    rng = np.random.default_rng(len(kind))
    if kind == "empty":
        return np.zeros((0,), np.float32)
    if kind == "one-block":
        return rng.standard_normal(256).astype(np.float32)
    if kind == "ragged-2d":
        return rng.standard_normal((300, 3)).astype(np.float32)
    if kind == "skewed":
        return (rng.standard_normal((1000, 7))
                * rng.lognormal(size=(1000, 7)) * 1e-3).astype(np.float32)
    if kind == "zero-blocks":
        a = np.zeros((700,), np.float32)
        a[300:310] = rng.standard_normal(10)
        return a
    if kind == "ties":
        # x / scale lands on k + 0.5 exactly: round half to even decides
        a = np.full((256,), 0.5, np.float32)
        a[0] = 127.0
        a[1:20] = np.arange(1, 20) + 0.5
        return a
    raise ValueError(kind)


KINDS = ["empty", "one-block", "ragged-2d", "skewed", "zero-blocks", "ties"]


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.numpy()
    return np.asarray(a)


@pytest.mark.parametrize("kind", KINDS)
def test_array_codec_bitwise_reference(kind):
    g = _array(kind)
    t = torch.from_numpy(g.copy())
    q, s = compression.quantize_array(t)
    wq, ws = ref.quantize_array(jnp.asarray(g))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(_np(q), _np(wq))
    np.testing.assert_array_equal(_np(s), _np(ws))
    back = compression.dequantize_array(q, s, shape=t.shape)
    np.testing.assert_array_equal(
        _np(back), _np(ref.dequantize_array(wq, ws, shape=g.shape)))
    np.testing.assert_array_equal(_np(compression.roundtrip_array(t)),
                                  _np(ref.roundtrip_array(jnp.asarray(g))))
    np.testing.assert_array_equal(
        _np(compression.bf16_roundtrip_array(t)),
        _np(ref.bf16_roundtrip_array(jnp.asarray(g))))
    if g.size:
        assert (float(compression.quantization_error_bound(t))
                == float(ref.quantization_error_bound(jnp.asarray(g))))


def test_tree_codec_bitwise_reference():
    """dict and list trees, an f32 and a bf16 leaf: q, scales, shapes and
    the round trip's values and dtypes are the reference's."""
    rng = np.random.default_rng(4)
    a = rng.standard_normal((37, 5)).astype(np.float32)
    b = rng.standard_normal((513,)).astype(np.float32)
    tree = {"a": torch.from_numpy(a), "l": [torch.from_numpy(b).to(
        torch.bfloat16)]}
    want_tree = {"a": jnp.asarray(a), "l": [jnp.asarray(b).astype(
        jnp.bfloat16)]}
    c = compression.quantize(tree)
    w = ref.quantize(want_tree)
    for got, want in ((c.q["a"], w.q["a"]), (c.q["l"][0], w.q["l"][0]),
                      (c.scales["a"], w.scales["a"]),
                      (c.scales["l"][0], w.scales["l"][0])):
        np.testing.assert_array_equal(_np(got), _np(want))
    assert c.shapes == {"a": (37, 5), "l": [(513,)]}
    out = compression.roundtrip(tree)
    want_out = ref.roundtrip(want_tree)
    assert out["a"].dtype == torch.float32
    assert out["l"][0].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["a"].numpy(), _np(want_out["a"]))
    np.testing.assert_array_equal(
        out["l"][0].float().numpy(),
        np.asarray(want_out["l"][0]).astype(np.float32))


def test_error_feedback_bitwise_reference():
    rng = np.random.default_rng(6)
    ef = compression.init_error_feedback({"w": torch.zeros(300)})
    wef = ref.init_error_feedback({"w": jnp.zeros(300)})
    for _ in range(5):
        g = rng.standard_normal(300).astype(np.float32)
        sent, ef = compression.compress_with_feedback(
            {"w": torch.from_numpy(g)}, ef)
        wsent, wef = ref.compress_with_feedback({"w": jnp.asarray(g)}, wef)
        np.testing.assert_array_equal(sent["w"].numpy(), _np(wsent["w"]))
        np.testing.assert_array_equal(ef.residual["w"].numpy(),
                                      _np(wef.residual["w"]))


@pytest.mark.parametrize("seed,scale", [(0, 0.1), (1, 1.0), (2, 37.0),
                                        (3, 100.0)])
def test_roundtrip_error_bound(seed, scale):
    rng = np.random.default_rng(seed)
    g = {"w": torch.from_numpy((scale * rng.standard_normal((300,))).astype(
        np.float32))}
    out = compression.roundtrip(g)
    err = (out["w"] - g["w"]).abs().max().item()
    bound = g["w"].abs().max().item() / 127.0 * 0.5 + 1e-6
    assert err <= bound * 1.001


def test_roundtrip_preserves_shape_dtype():
    g = {"a": torch.ones((7, 13), dtype=torch.bfloat16),
         "b": torch.zeros((5,), dtype=torch.float32)}
    out = compression.roundtrip(g)
    for k in g:
        assert out[k].shape == g[k].shape and out[k].dtype == g[k].dtype


@pytest.mark.parametrize("seed,size", [(0, 1), (1, 255), (2, 257),
                                       (3, 700)])
def test_elementwise_scale_bound(seed, size):
    """Each block's error within half its own scale;
    ``quantization_error_bound`` is half the largest scale."""
    rng = np.random.default_rng(seed)
    g = torch.from_numpy((rng.standard_normal((size,))
                          * rng.lognormal(size=(size,))).astype(np.float32))
    q, scales = compression.quantize_array(g)
    err = (compression.dequantize_array(q, scales, shape=g.shape)
           - g).abs().numpy()
    s = scales.numpy()
    for i in range(len(s)):
        blk = err[i * compression.BLOCK:(i + 1) * compression.BLOCK]
        assert blk.max() <= s[i] * 0.5 * (1 + 1e-6) + 1e-12, (i, s[i])
    bound = float(compression.quantization_error_bound(g))
    np.testing.assert_allclose(bound, s.max() * 0.5, rtol=1e-6)


def test_error_feedback_drift_free_vs_naive():
    """A signal far below one quantization step: the naive codec rounds it
    away every round, error feedback delivers it within one step."""
    rounds, n = 200, 64
    base = torch.linspace(-1.0, 1.0, n)
    tiny = 1e-4
    ef = compression.init_error_feedback({"w": torch.zeros(n)})
    naive_sum = np.zeros(n)
    ef_sum = np.zeros(n)
    for _ in range(rounds):
        payload = {"w": base + tiny}
        naive_sum += compression.roundtrip(payload)["w"].numpy()
        sent, ef = compression.compress_with_feedback(payload, ef)
        ef_sum += sent["w"].numpy()
    true_sum = (base + tiny).numpy().astype(np.float64) * rounds
    step = 2.0 / 127.0
    naive_err = np.abs(naive_sum - true_sum).max()
    ef_err = np.abs(ef_sum - true_sum).max()
    assert ef_err <= step * 1.5, ef_err
    assert naive_err >= rounds * tiny * 0.9
    assert ef_err < naive_err / 5


def test_error_feedback_reduces_bias():
    ef = compression.init_error_feedback({"w": torch.zeros(64)})
    sent_sum = torch.zeros(64)
    for _ in range(50):
        sent, ef = compression.compress_with_feedback(
            {"w": torch.full((64,), 1e-4)}, ef)
        sent_sum = sent_sum + sent["w"]
    np.testing.assert_allclose(float((sent_sum / 50).mean()), 1e-4,
                               rtol=0.2)
