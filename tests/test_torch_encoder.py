"""The encoder (hubert-xlarge: bidirectional ``encoder`` layers over the
``frames`` frontend, no RoPE) of the PyTorch port against the JAX
``Model`` on the same weights: ``forward`` and ``prefill`` logits on
the kernel route and on the plain route (with a right-padded batch),
the capability flags, and the engine's refusal.

f32 on the CPU, logits within 1e-4 (the two frameworks sum the same
f32 products in another order).  The kernel route is JAX's
``use_kernels=True`` on its default "jnp" backend (its flash oracle)
against the port's ``use_kernels=True`` on the CPU (the flash kernel's
plain version); neither kernel takes ``lens``, so that route is held on
full lengths, as JAX's kernel route requires.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core.request import Request as JRequest  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serving.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.request import Request  # noqa: E402
from repro_torch.models.build import Model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving.engine import EngineConfig, InferenceEngine  # noqa: E402,E501

TOL = 1e-4
ARCH = "hubert-xlarge"
B, S = 2, 24


@functools.lru_cache(maxsize=None)
def _jax(use_kernels=False):
    jm = jax_build(jax_smoke(ARCH), use_kernels=use_kernels)
    jp = jm.init(jax.random.key(4))
    return jm, jp, jax.tree.map(np.asarray, jp)


def _port(use_kernels=False):
    cfg = get_smoke_config(ARCH)
    model = Model(cfg, device="cpu", use_kernels=use_kernels)
    model.load_state_dict(params_from_jax(_jax()[2], cfg))
    return model


def _frames(seed=6):
    d = get_smoke_config(ARCH).d_model
    return np.random.default_rng(seed).standard_normal((B, S, d), np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


def test_smoke_config_is_jaxs():
    """The reduced config the tests run: 2 encoder layers, d 64, 4 heads
    of 16, d_ff 128, a 256-entry codebook head, bidirectional frames."""
    cfg = get_smoke_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff,
            cfg.vocab_size) == (2, 64, 4, 128, 256)
    assert cfg.layer_pattern() == (("encoder", 2),)
    assert cfg.is_encoder_only and cfg.frontend == "frames"
    assert _port().kinds == ["encoder", "encoder"]


@pytest.mark.parametrize("use_kernels", [True, False],
                         ids=["kernel_route", "plain_route"])
def test_forward_and_prefill_match_jax_on_full_lengths(use_kernels):
    """``forward`` logits (B, S, V) and ``prefill`` logits at the last
    frame, against JAX's on the same weights and frames; an encoder-only
    model builds no cache (None per layer; JAX's segment caches are None
    too)."""
    jm, jp, _ = _jax(use_kernels)
    model = _port(use_kernels)
    frames = _frames()
    lens = np.full(B, S, np.int32)
    want = jm.forward(jp, {"frames": jnp.asarray(frames)})
    got = model.forward({"frames": torch.as_tensor(frames)})
    assert got.shape == (B, S, model.cfg.vocab_size)
    _close(got, want)
    want, jcaches = jm.prefill(jp, jnp.asarray(frames), jnp.asarray(lens))
    got, caches = model.prefill(torch.as_tensor(frames),
                                torch.as_tensor(lens))
    _close(got, want)
    assert caches == [None, None] and jcaches == [None]


def test_plain_route_masks_right_padded_frames():
    """A right-padded batch (lens 24 and 15) on the plain route: forward
    and prefill logits equal JAX's with the same ``lens``, and the padded
    row's valid positions equal that row run alone at its own length —
    the bidirectional layers never see its padded frames."""
    jm, jp, _ = _jax()
    model = _port()
    frames = _frames(7)
    lens = np.array([S, 15], np.int32)
    frames[1, 15:] = 100.0      # padding a leak would show
    batch = {"frames": torch.as_tensor(frames), "lens": torch.as_tensor(lens)}
    want = jm.forward(jp, {"frames": jnp.asarray(frames),
                           "lens": jnp.asarray(lens)})
    got = model.forward(batch)
    _close(got, want)
    alone = model.forward({"frames": torch.as_tensor(frames[1:, :15])})
    torch.testing.assert_close(got[1, :15], alone[0], rtol=1e-5, atol=1e-5)
    want, _ = jm.prefill(jp, jnp.asarray(frames), jnp.asarray(lens))
    got, _ = model.prefill(torch.as_tensor(frames), torch.as_tensor(lens))
    _close(got, want)
    torch.testing.assert_close(got[1], alone[0, -1], rtol=1e-5, atol=1e-5)


def test_frames_loss_matches_jax():
    """The masked-prediction loss over frames (``labels`` and a 15 %
    ``mask``) equals JAX's ``Model.loss``."""
    jm, jp, _ = _jax()
    rng = np.random.default_rng(8)
    batch = {"frames": _frames(8),
             "labels": rng.integers(0, 256, (B, S)).astype(np.int32),
             "mask": (rng.random((B, S)) < 0.15).astype(np.float32)}
    want = jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    got = _port().loss({k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=TOL)


def test_capability_flags_match_jax():
    """Encoder-only, frames frontend: no chunked prefill, prefix cache or
    speculation, in both packages."""
    flags = ("supports_chunked", "supports_prefix_cache",
             "supports_spec_decode")
    jm = _jax()[0]
    for use_kernels in (True, False):
        model = _port(use_kernels)
        assert [getattr(model, f) for f in flags] == [
            getattr(jm, f) for f in flags] == [False, False, False]


def test_engine_refuses_hubert_as_jax_does():
    """The paged plane refuses the model at construction with JAX's
    ``ValueError``; left to pick its plane, each engine takes the slot
    plane and builds, and its first step — the prefill of a token
    prompt, which a frames model cannot embed — raises ``ValueError``
    in both packages."""
    jm, jp, _ = _jax()
    model = _port()
    with pytest.raises(ValueError) as jerr:
        JEngine(jm, jp, JEngineConfig.smoke(paged=True))
    with pytest.raises(ValueError) as err:
        InferenceEngine(model, EngineConfig.smoke(paged=True))
    assert str(err.value) == str(jerr.value)
    jeng = JEngine(jm, jp, JEngineConfig.smoke())
    eng = InferenceEngine(model, EngineConfig.smoke())
    assert jeng.paged is eng.paged is False
    prompt = np.arange(5, dtype=np.int32)
    jeng.submit(JRequest(rid=0, l_in=5, l_out=3, prompt=prompt))
    eng.submit(Request(rid=0, l_in=5, l_out=3, prompt=prompt))
    with pytest.raises(ValueError):
        jeng.step()
    with pytest.raises(ValueError, match="frames frontend"):
        eng.step()
