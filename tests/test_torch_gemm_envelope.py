"""The shapes the port's encoder layer kernels take, on the CPU.

The card's encoder GEMM (``csrc/encoder_layer.cu`` on ``csrc/wgmma.cuh``'s
main loop) takes N % 128 == 0 and any K with 16-byte rows; the attention
takes head widths 32 and 64; the LayerNorm D <= 1024.  The wrappers of
``bergen_tpu_torch.ops.encoder_attention`` check exactly that before any
launch.  Here each wrapper is called with tensors on the ``meta`` device
and the launch layer replaced by a stub: a shape the kernels take must get
as far as its first launch, and any other must raise ``ValueError`` before
it.  Layer widths are the published ``config.json`` values of the encoders
that the repository's retriever and reranker configs name."""

import pytest
import torch

from bergen_tpu_torch.models import bert
from bergen_tpu_torch.ops import encoder_attention as ea

# (D, heads, I, act): absolute-position encoders with a plain GELU MLP
SHIPPED = {
    "bge-base-en-v1.5": (768, 12, 3072, "gelu"),
    "bge-large-en-v1.5": (1024, 16, 4096, "gelu"),
    "bge-small-en-v1.5": (384, 12, 1536, "gelu"),
    "ms-marco-MiniLM-L-6-v2": (384, 12, 1536, "gelu"),
    "bge-large-en (the bge reranker)": (1024, 16, 4096, "gelu"),
    "e5-base-v2": (768, 12, 3072, "gelu"),
    "e5-large-v2": (1024, 16, 4096, "gelu"),
    "bge-m3 (XLM-R large)": (1024, 16, 4096, "gelu"),
}
DEBERTA_V3_BASE = (768, 12, 3072, "gelu")  # trecdl22-crossencoder-debertav3
# (D, heads, I, act) the kernels do not take, and why
OUTSIDE = {
    "D % 128": (832, 13, 3328, "gelu"),
    "I % 128": (768, 12, 3000, "gelu"),
    "D > 1024 (LayerNorm)": (1280, 20, 5120, "gelu"),
    "head width 80": (640, 8, 2560, "gelu"),
    "head width 128": (1024, 8, 4096, "gelu"),
    "activation": (768, 12, 3072, "tanh"),
}


class _Launch(Exception):
    """Raised by the stubbed launch layer: the checks let the call through."""


@pytest.fixture
def no_launch(monkeypatch):
    def function(name):
        raise _Launch(name)

    monkeypatch.setattr(ea, "_on_card", lambda fn, x: None)
    monkeypatch.setattr(ea._build, "function", function)
    monkeypatch.setattr(ea._build, "stream_ptr", lambda device: 0)


def _meta_layer(D, I):
    def w(*shape, dtype=torch.bfloat16):
        return torch.empty(*shape, dtype=dtype, device="meta")

    f32 = torch.float32
    return {
        "attn": {n: {"kernel": w(D, D), "bias": w(D, dtype=f32)}
                 for n in "qkvo"},
        "attn_ln": {"scale": w(D, dtype=f32), "bias": w(D, dtype=f32)},
        "mlp_in": {"kernel": w(D, I), "bias": w(I, dtype=f32)},
        "mlp_out": {"kernel": w(I, D), "bias": w(D, dtype=f32)},
        "mlp_ln": {"scale": w(D, dtype=f32), "bias": w(D, dtype=f32)},
    }


def _inputs(D, B=3, S=40):
    x = torch.empty(B, S, D, dtype=torch.bfloat16, device="meta")
    mask = torch.empty(B, S, dtype=torch.int32, device="meta")
    return x, mask


def _call(kind, shape):
    D, H, I, act = shape
    x, mask = _inputs(D)
    B, S, _ = x.shape
    if kind == "encoder_layer":
        ea.encoder_layer(x, ea.fuse_layer(_meta_layer(D, I)), mask, H, 1e-12,
                         act)
    elif kind == "attention_block":
        ea.attention_block(x, ea.fuse_block(_meta_layer(D, I)), mask, H,
                           1e-12)
    else:
        qkv = torch.empty(B, S, 3 * D, dtype=torch.bfloat16, device="meta")
        bias = torch.empty(B, H, S, S, dtype=torch.bfloat16, device="meta")
        ea.encoder_layer_prebias(x, qkv, bias,
                                 ea.fuse_layer(_meta_layer(D, I)), mask, H,
                                 1e-7, act, 0.1)


@pytest.mark.parametrize("name", sorted(SHIPPED))
@pytest.mark.parametrize("kind", ["encoder_layer", "attention_block"])
def test_shipped_layers_reach_the_kernels(no_launch, name, kind):
    with pytest.raises(_Launch) as hit:
        _call(kind, SHIPPED[name])
    assert hit.value.args[0] == "encoder_gemm"  # the qkv GEMM comes first


def test_deberta_tail_reaches_the_kernels(no_launch):
    with pytest.raises(_Launch) as hit:
        _call("prebias", DEBERTA_V3_BASE)
    assert hit.value.args[0] == "encoder_attention"


@pytest.mark.parametrize("why", sorted(OUTSIDE))
@pytest.mark.parametrize("kind", ["encoder_layer", "prebias"])
def test_outside_shapes_raise_before_any_launch(no_launch, why, kind):
    with pytest.raises(ValueError):
        _call(kind, OUTSIDE[why])


@pytest.mark.parametrize("why", sorted(OUTSIDE))
def test_check_layer_shape_refuses(why):
    with pytest.raises(ValueError):
        ea.check_layer_shape("encoder_layer", *OUTSIDE[why])


def test_prebias_needs_whole_bias_rows(no_launch):
    D, H, I, act = DEBERTA_V3_BASE
    x, mask = _inputs(D, S=36)
    qkv = torch.empty(3, 36, 3 * D, dtype=torch.bfloat16, device="meta")
    bias = torch.empty(3, H, 36, 36, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="S % 8"):
        ea.encoder_layer_prebias(x, qkv, bias,
                                 ea.fuse_layer(_meta_layer(D, I)), mask, H,
                                 1e-7, act, 0.1)


@pytest.mark.parametrize("name", sorted(SHIPPED))
def test_layer_route_and_check_agree(name):
    """``_layer_route`` sends a config to the layer kernel by its position
    embedding, MLP and activation; for every shipped absolute encoder it
    does, and the kernels' shape check accepts the config's widths."""
    D, H, I, act = SHIPPED[name]
    cfg = bert.BertConfig(hidden_size=D, num_heads=H, intermediate_size=I,
                          hidden_act=act)
    assert bert._layer_route(cfg)
    ea.check_layer_shape("encoder_layer", D, H, I, act)


@pytest.mark.parametrize("position,gated,act", [
    ("rope", True, "silu"),     # nomic-embed-text-v1.5
    ("alibi", True, "gelu"),    # jina-embeddings-v2-base-en
    ("rope", True, "gelu"),     # gte-base-en-v1.5
    ("absolute", False, "tanh"),
])
def test_layer_route_declines_other_encoders(position, gated, act):
    cfg = bert.BertConfig(position_embedding_type=position, mlp_gated=gated,
                          hidden_act=act)
    assert not bert._layer_route(cfg)
