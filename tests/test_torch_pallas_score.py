"""The port's ``pallas_score`` (``bergen_tpu_torch.ops.scoring``) on the CPU,
where it runs ``pallas_score_plain``, against the JAX package's
``xla_score``, which computes the same function (JAX's ``pallas_score`` has
no interpret switch, so it cannot run on the CPU): bf16 queries and a
pre-transposed bf16 corpus, f32 scores within 1e-5 relative (exact products,
f32 sums in another order).  And the selector: the port's ``topk_blocked``
gives the same ids and scores with ``_use_pallas`` forced on (the
``pallas_score`` branch, as JAX's ``scoring.py:191``) and off, and off is
what it returns."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bergen_tpu.ops.scoring import xla_score
from bergen_tpu_torch.ops import scoring as tsc

RTOL = 1e-5


def _bf16_inputs(seed: int, Q: int, D: int, N: int):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((Q, D), np.float32)).bfloat16()
    c = torch.from_numpy(rng.standard_normal((N, D), np.float32)).bfloat16()
    return q, c


@pytest.mark.parametrize("Q,D,N", [(8, 64, 256), (37, 96, 300),
                                   (130, 768, 1024)])
def test_plain_matches_jax_xla_score(Q, D, N):
    q, c = _bf16_inputs(Q + N, Q, D, N)
    ct = c.T.contiguous()
    ref = np.asarray(xla_score(jnp.asarray(q.float().numpy(), jnp.bfloat16),
                               jnp.asarray(ct.float().numpy(), jnp.bfloat16)))
    before = tsc.pallas_score.launches
    out = tsc.pallas_score(q, ct)
    assert tsc.pallas_score.launches == before  # no kernel on the CPU
    assert out.dtype == torch.float32 and out.shape == (Q, N)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out.numpy(), ref, atol=RTOL * scale, rtol=0)


@pytest.mark.parametrize("block,valid_n", [(1 << 17, None), (96, 250)])
def test_topk_blocked_same_ids_with_pallas_branch(monkeypatch, block,
                                                  valid_n):
    assert tsc._use_pallas() is False  # as JAX: no path takes the branch
    q, c = _bf16_inputs(3, 20, 64, 300)
    qf, cf = q.float(), c.float()  # bf16 values: exact in either branch
    off_v, off_i = tsc.topk_blocked(qf, cf, 10, valid_n=valid_n, block=block)
    monkeypatch.setattr(tsc, "_use_pallas", lambda: True)
    on_v, on_i = tsc.topk_blocked(qf, cf, 10, valid_n=valid_n, block=block)
    assert torch.equal(on_i, off_i)
    np.testing.assert_allclose(on_v.numpy(), off_v.numpy(), rtol=RTOL,
                               atol=RTOL)
    if valid_n is not None:
        assert int(on_i.max()) < valid_n


def test_wrapper_refuses_other_devices():
    x = torch.zeros(4, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tsc.pallas_score(x, x.T)


# --------------------------------------------------------------------------- #
# the kernel's shape envelope, on meta tensors with the launch layer stubbed
# --------------------------------------------------------------------------- #

class _Launch(Exception):
    """Raised by the stubbed launch: the checks let the call through."""


@pytest.fixture
def no_launch(monkeypatch):
    """The launches the wrapper makes: (C entry, its arguments)."""
    calls = []

    def function(name):
        def launch(*args):
            calls.append((name, args))
            raise _Launch(name)
        return launch

    monkeypatch.setattr(tsc, "_on_card", lambda x: None)
    monkeypatch.setattr(tsc._build, "function", function)
    monkeypatch.setattr(tsc._build, "stream_ptr", lambda device: 0)
    return calls


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


def _launched(calls, q, ct):
    before = tsc.pallas_score.launches
    with pytest.raises(_Launch):
        tsc.pallas_score(q, ct)
    assert tsc.pallas_score.launches == before
    (name, args), = calls
    assert name == "pallas_score"
    return args[3:6]  # Q, D, N as launched


@pytest.mark.parametrize("Q,D,N", [(2_048, 768, 262_144), (50, 768, 1_000),
                                   (3, 8, 8), (300, 1_032, 4_104)])
def test_whole_rows_reach_the_kernel_unpadded(no_launch, Q, D, N):
    """D % 8 == 0 and N % 8 == 0: TMA's 16-byte rows, no copy."""
    assert _launched(no_launch, _meta(Q, D), _meta(D, N)) == (Q, D, N)


@pytest.mark.parametrize("N", [1, 1_003, 262_145])
def test_ragged_corpus_pads_to_whole_rows(no_launch, N):
    """N % 8 != 0: the corpus is padded to the next multiple of 8."""
    got = _launched(no_launch, _meta(16, 768), _meta(768, N))
    assert got == (16, 768, -(-N // 8) * 8)


OUTSIDE = {
    "D % 8": (_meta(16, 100), _meta(100, 256)),
    "D % 8, one column": (_meta(16, 1), _meta(1, 256)),
    "f32 queries": (_meta(16, 64, dtype=torch.float32), _meta(64, 256)),
    "f16 corpus": (_meta(16, 64), _meta(64, 256, dtype=torch.float16)),
    "corpus depth": (_meta(16, 64), _meta(72, 256)),
    "corpus not contiguous": (_meta(16, 64), _meta(256, 64).T),
    "queries not contiguous": (_meta(64, 16).T, _meta(64, 256)),
}


@pytest.mark.parametrize("why", sorted(OUTSIDE))
def test_outside_shapes_raise_before_any_launch(no_launch, why):
    with pytest.raises(ValueError):
        tsc.pallas_score(*OUTSIDE[why])
    assert not no_launch
