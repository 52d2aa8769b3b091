"""GGUF checkpoints on the port (``models/gguf.py``,
``Tokenizer.from_gguf``, ``LLM(gguf_file=...)``) on the CPU, on files that
``tests/gguf_files.py`` writes (the published ``gorilla-7b-hf-v1-q6_K.gguf``
is not in the repository, and neither machine has the ``gguf`` package).

* Each block type's dequantizer (F32, F16, BF16, Q8_0, Q4_K, Q5_K, Q6_K)
  is bit-equal in f32 to a numpy loop written from llama.cpp's
  ``ggml-quants.c`` on seeded random blocks (every code and scale byte
  drawn, negative scales, the all-clear and all-set blocks), and so is the
  vectorised numpy dequantizer ``chip_smoke.py`` uses.
* The reader against hand-built headers (versions 2 and 3, the default
  and other alignments, every value type and arrays of each); other block
  types, versions and architectures raise, naming them.
* The q/k un-permute against transformers' ``LlamaTensorProcessor``.
* The tokenizer against transformers' own GGUF path
  (``AutoTokenizer.from_pretrained(gguf_file=...)``, its
  ``GGUFLlamaConverter``, with the file read through a stand-in ``gguf``
  module): ids and decoded text on a fixed list of strings, with and
  without merges, and the bos / eos / pad ids JAX's ``LLM`` uses.
* The whole: the same blocks, dequantized by the numpy loop and
  un-permuted by transformers, through JAX's ``llama_from_hf`` and
  ``greedy_generate``: the port's ``LLM(gguf_file=...)`` gives the same
  greedy tokens, and first-step logits within 1e-5 (f32).
* The file with int4 and the servers, and under two gloo ranks (tp 1's
  tokens, logits within 1e-4).
* ``gorilla-7b-hf-v1-gguf`` through the port's CLI on rag_ut1.
"""

import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import gguf_files as G  # noqa: E402

LOGITS_ATOL = 1e-5
TYPES = [G.F32, G.F16, G.BF16, G.Q8_0, G.Q4_K, G.Q5_K, G.Q6_K]
NAMES = {G.F32: "F32", G.F16: "F16", G.BF16: "BF16", G.Q8_0: "Q8_0",
         G.Q4_K: "Q4_K", G.Q5_K: "Q5_K", G.Q6_K: "Q6_K"}
STRINGS = ["hello world", " leading space", "  two  leading spaces",
           "Ünïcödé accents é à", "中文 字符 漢字", "emoji 😀 and 🚀",
           "<s> special </s> and <unk> tokens",
           "What is the capital of France ?", "tabs\tand\nnewlines", ""]
# a tiny llama whose every 2-D tensor is a K-quant block multiple: one
# block type per tensor, every type the reader dequantizes
CFG = dict(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=512, rms_norm_eps=1e-5)
MIX = {"token_embd": G.Q6_K, "output": G.Q6_K, "attn_q": G.Q4_K,
       "attn_k": G.Q5_K, "attn_v": G.Q8_0, "attn_output": G.F16,
       "ffn_gate": G.BF16, "ffn_up": G.Q6_K, "ffn_down": G.Q4_K}


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch thread for this module (the suite runs several workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mix(name: str) -> int:
    return MIX.get(name.split(".")[-2], G.F32)


@pytest.fixture(scope="module")
def vocab():
    """A llama-layout vocabulary over the ut1 text: sentencepiece BPE
    pieces and merges learnt from it, padded to 640 tokens."""
    from bergen_tpu_torch.models import tokenizer as T
    from test_torch_tokenizer_gemma_cohere import _ut1_texts

    chars, merges = T.train_sentencepiece_bpe(_ut1_texts(), 300, 259)
    tokens, scores, types = G.llama_vocab(sorted(chars, key=chars.get), 640,
                                          seed=1)
    return tokens, scores, types, merges


def _write_model(folder, vocab, name="model-q6_K.gguf", **meta):
    tokens, scores, types, _ = vocab
    cfg = dict(CFG, vocab_size=len(tokens))
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(str(folder), name)
    tensors = G.llama_tensors(cfg, np.random.default_rng(5), _mix,
                              norm_std=0.1)
    G.write_gguf(path, G.llama_metadata(cfg, tokens, scores, types, **meta),
                 tensors)
    return path, tensors


@pytest.fixture(scope="module")
def model(tmp_path_factory, vocab):
    folder = tmp_path_factory.mktemp("gguf")
    return folder, *_write_model(folder, vocab)


# --------------------------------------------------------------------------- #
# blocks and the reader
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("ttype", TYPES, ids=[NAMES[t] for t in TYPES])
def test_dequantizers_bit_equal_to_the_ggml_loop(ttype):
    from bergen_tpu_torch.models import gguf

    rng = np.random.default_rng(ttype)
    n = 4 * 256
    if ttype in G.QUANTIZED:
        raw = G.random_blocks(rng, ttype, n, extremes=True)
    else:
        x = rng.standard_normal(n) * 10.0 ** rng.integers(-6, 4, n)
        x[:4] = [0.0, -0.0, 65504.0, -1e-7]
        raw = G.float_bytes(x, ttype)
    want = G.dequantize_loop(raw, ttype)
    got = gguf.dequantize(torch.frombuffer(bytearray(raw), dtype=torch.uint8),
                          ttype).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(G.dequantize_np(raw, ttype).view(np.uint32),
                                  want.view(np.uint32))
    if ttype in (G.Q6_K, G.Q8_0):  # negative scales occur
        assert (want < 0).any() and (want > 0).any()


def _hand_header(version: int, kv: list, tensors: list, align: int) -> bytes:
    """A GGUF header by hand: the magic, version, counts, each key-value
    (``(key, type, packed value)``) and tensor info, padded to ``align``."""
    out = b"GGUF" + struct.pack("<IQQ", version, len(tensors), len(kv))
    for key, vtype, packed in kv:
        out += struct.pack("<Q", len(key)) + key.encode()
        out += struct.pack("<I", vtype) + packed
    for name, dims, ttype, offset in tensors:
        out += struct.pack("<Q", len(name)) + name.encode()
        out += struct.pack(f"<I{len(dims)}QIQ", len(dims), *dims, ttype,
                           offset)
    return out + b"\0" * (-len(out) % align)


@pytest.mark.parametrize("version,align", [(2, None), (3, None), (3, 48),
                                           (2, 8)])
def test_reader_against_a_hand_built_header(tmp_path, version, align):
    from bergen_tpu_torch.models import gguf

    s = "arch".encode()
    kv = [("general.architecture", 8, struct.pack("<Q", len(s)) + s),
          ("a.u8", 0, struct.pack("<B", 200)),
          ("a.i8", 1, struct.pack("<b", -100)),
          ("a.u16", 2, struct.pack("<H", 60000)),
          ("a.i16", 3, struct.pack("<h", -30000)),
          ("a.u32", 4, struct.pack("<I", 4_000_000_000)),
          ("a.i32", 5, struct.pack("<i", -2_000_000_000)),
          ("a.f32", 6, struct.pack("<f", 0.1)),
          ("a.bool", 7, struct.pack("<?", True)),
          ("a.u64", 10, struct.pack("<Q", 1 << 60)),
          ("a.i64", 11, struct.pack("<q", -(1 << 60))),
          ("a.f64", 12, struct.pack("<d", 0.1)),
          ("a.arr_i32", 9, struct.pack("<IQ3i", 5, 3, -1, 0, 7)),
          ("a.arr_str", 9, struct.pack("<IQ", 8, 2) + struct.pack("<Q", 1)
           + b"x" + struct.pack("<Q", 3) + "é!".encode()),
          ("a.arr_arr", 9, struct.pack("<IQ", 9, 2)
           + struct.pack("<IQ2B", 0, 2, 1, 2) + struct.pack("<IQ", 7, 0))]
    if align is not None:
        kv.append(("general.alignment", 4, struct.pack("<I", align)))
    a = align or 32
    x = np.arange(6, dtype=np.float32) - 2.5
    y = np.arange(4, dtype=np.float16)
    off_y = -(-x.nbytes // a) * a
    head = _hand_header(version, kv, [("x", (3, 2), 0, 0),
                                      ("y", (4,), 1, off_y)], a)
    path = tmp_path / "h.gguf"
    path.write_bytes(head + x.tobytes() + b"\0" * (off_y - x.nbytes)
                     + y.tobytes())
    gf = gguf.GGUFFile(str(path))
    m = gf.metadata
    assert gf.version == version
    assert (m["a.u8"], m["a.i8"], m["a.u16"], m["a.i16"], m["a.u32"],
            m["a.i32"], m["a.bool"], m["a.u64"], m["a.i64"], m["a.f64"]) == (
        200, -100, 60000, -30000, 4_000_000_000, -2_000_000_000, True,
        1 << 60, -(1 << 60), 0.1)
    assert m["a.f32"] == float(np.float32(0.1))
    assert m["a.arr_i32"] == [-1, 0, 7] and m["a.arr_str"] == ["x", "é!"]
    assert m["a.arr_arr"] == [[1, 2], []]
    assert gf.tensors["x"].shape == (2, 3) and gf.tensors["x"].start == \
        len(head)
    assert gf.tensors["y"].start == len(head) + off_y
    np.testing.assert_array_equal(gf.dequantize("x").numpy(),
                                  x.reshape(2, 3))
    np.testing.assert_array_equal(gf.dequantize("y").numpy(),
                                  y.astype(np.float32))


def test_writer_round_trips_every_value_type(tmp_path):
    """Every value type and an array of each through the tests' writer,
    read back by the port and by transformers' parser (the stand-in
    reader's fields)."""
    from transformers.integrations.ggml import _gguf_parse_value

    from bergen_tpu_torch.models import gguf

    values = {G.U8: 3, G.I8: -3, G.U16: 9, G.I16: -9, G.U32: 70000,
              G.I32: -70000, G.F32V: 0.25, G.BOOL: False, G.U64: 1 << 40,
              G.I64: -(1 << 40), G.F64: 1e-300, G.STR: "ñ"}
    kv = {f"k.{t}": (t, v) for t, v in values.items()}
    kv.update({f"k.arr{t}": (G.ARR, (t, [v, v])) for t, v in values.items()})
    path = G.write_gguf(str(tmp_path / "v.gguf"), kv, [], alignment=64)
    got = gguf.GGUFFile(path).metadata
    fields = G.FakeReader(path).fields
    for key, (t, v) in kv.items():
        want = v if t != G.ARR else v[1]
        assert got[key] == want, key
        parsed = [_gguf_parse_value(fields[key].parts[i], fields[key].types)
                  for i in fields[key].data]
        assert (parsed if t == G.ARR else parsed[0]) == want, key


def test_refusals_name_what_they_refuse(tmp_path, vocab):
    from bergen_tpu_torch.models import gguf

    path = G.write_gguf(str(tmp_path / "q40.gguf"), {
        "general.architecture": "falcon"},
        [("t", 2, (1, 32), b"\0" * 18)])
    gf = gguf.GGUFFile(path)
    with pytest.raises(NotImplementedError, match="Q4_0.*models/gguf.py"):
        gf.dequantize("t")
    with pytest.raises(NotImplementedError, match="'falcon'"):
        gguf.hf_config(gf)
    old = tmp_path / "v1.gguf"
    old.write_bytes(b"GGUF" + struct.pack("<III", 1, 0, 0))
    with pytest.raises(NotImplementedError, match="version 1"):
        gguf.GGUFFile(str(old))
    with pytest.raises(FileNotFoundError, match="missing.gguf"):
        gguf.find(str(tmp_path), "missing.gguf")


@pytest.mark.parametrize("heads", [(4, 4), (4, 2), (8, 1)])
def test_unpermute_matches_transformers(heads):
    from transformers.modeling_gguf_pytorch_utils import \
        LlamaTensorProcessor

    from bergen_tpu_torch.models import gguf

    H, KH = heads
    Dh, D = 16, 24
    rng = np.random.default_rng(H * 10 + KH)
    proc = LlamaTensorProcessor(config={"num_attention_heads": H,
                                        "num_key_value_heads": KH})
    for name, n, rows in (("blk.0.attn_q.weight", H, H * Dh),
                          ("blk.0.attn_k.weight", KH, KH * Dh)):
        w = rng.standard_normal((rows, D)).astype(np.float32)
        want = proc.process(w, name).weights
        got = gguf.unpermute(torch.from_numpy(w), n).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            gguf.unpermute(torch.from_numpy(G.permute(w, n)), n).numpy(), w)


# --------------------------------------------------------------------------- #
# the tokenizer
# --------------------------------------------------------------------------- #


def test_merges_match_transformers(vocab):
    from transformers.integrations.ggml import GGUFTokenizerSkeleton

    from bergen_tpu_torch.models.tokenizer import gguf_merges

    tokens, scores, _, _ = vocab
    want = GGUFTokenizerSkeleton({"tokens": tokens, "scores": scores}).merges
    assert gguf_merges(tokens, scores) == want and len(want) > 300


@pytest.mark.parametrize("case", ["scores", "merges", "no_prefix"])
def test_tokenizer_matches_transformers(tmp_path, vocab, monkeypatch, case):
    """transformers' GGUF tokenizer (``LlamaTokenizerFast`` over
    ``GGUFLlamaConverter``) and the port's: the same ids, the same decoded
    text with and without the special tokens; the eos token is the bos
    string (``ggml.py:403-404``), and JAX's pad rule (bos > pad > eos)
    gives the bos id; bos is added whatever ``add_bos_token`` says, and
    ``padding_token_id`` sets no pad token (transformers maps neither)."""
    from transformers import AutoTokenizer

    from bergen_tpu_torch.models import gguf
    from bergen_tpu_torch.models.tokenizer import Tokenizer

    tokens, scores, types, merges = vocab
    meta = {}
    if case == "merges":
        meta["merges"] = list(merges)
    if case == "no_prefix":  # and the keys transformers does not map
        meta["extra"] = {"tokenizer.ggml.add_space_prefix": False,
                         "tokenizer.ggml.add_bos_token": False,
                         "tokenizer.ggml.padding_token_id": 2}
    path, _ = _write_model(tmp_path, vocab, **meta)
    G.fake_gguf(monkeypatch)
    ref = AutoTokenizer.from_pretrained(str(tmp_path),
                                        gguf_file=os.path.basename(path))
    port = Tokenizer.from_gguf(gguf.GGUFFile(path).metadata)
    for s in STRINGS:
        ids = ref(s)["input_ids"]
        assert port(s)["input_ids"] == ids, s
        for skip in (False, True):
            assert port.decode(ids, skip_special_tokens=skip) == \
                ref.decode(ids, skip_special_tokens=skip), (s, skip)
    assert (port.bos_token, port.eos_token, port.unk_token) == (
        ref.bos_token, ref.eos_token, ref.unk_token) == ("<s>", "<s>",
                                                           "<unk>")
    pad = ref.bos_token or ref.pad_token or ref.eos_token  # jax_llm.py:77
    port.pad_token = port.bos_token or port.pad_token or port.eos_token
    assert (port.bos_token_id, port.eos_token_id, port.pad_token_id) == (
        ref.bos_token_id, ref.eos_token_id,
        ref.convert_tokens_to_ids(pad)) == (1, 1, 1)
    assert ref.pad_token is None and ref("a")["input_ids"][0] == 1


# --------------------------------------------------------------------------- #
# the whole
# --------------------------------------------------------------------------- #


def test_llm_gguf_matches_jax(model, monkeypatch):
    """The same blocks through the numpy loop, transformers' un-permute,
    JAX's ``llama_from_hf`` and ``greedy_generate``, and through the port's
    ``LLM(gguf_file=...)``: the same greedy tokens, first-step logits
    within LOGITS_ATOL (f32)."""
    import jax.numpy as jnp
    from transformers import AutoConfig
    from transformers.modeling_gguf_pytorch_utils import \
        LlamaTensorProcessor

    from bergen_tpu.models import convert as jc, llama as jl
    from bergen_tpu_torch.models.generators.llm import LLM

    folder, path, tensors = model
    G.fake_gguf(monkeypatch)
    hf_cfg = AutoConfig.from_pretrained(str(folder),
                                        gguf_file=os.path.basename(path))
    proc = LlamaTensorProcessor(config=hf_cfg.to_dict())
    sd = {}
    for name, ttype, shape, raw in tensors:
        w = G.dequantize_loop(raw, ttype).reshape(shape)
        sd[G.HF_NAMES(name)] = torch.from_numpy(
            np.ascontiguousarray(proc.process(w, name).weights))
    cfg = jl.LlamaConfig.from_hf(hf_cfg)
    params = jc.to_device_tree(jc.llama_from_hf(sd, cfg.num_layers),
                               dtype=jnp.float32)
    llm = LLM(str(folder), gguf_file=os.path.basename(path),
              max_new_tokens=6, max_length=64, device="cpu")
    assert llm.cfg.vocab_size == cfg.vocab_size == len(
        llm.tokenizer.model.vocab)
    prompts = ["what is the capital of france ?",
               "tell me about the river bank and the fish in it"]
    ii, am = llm._tokenize_left_pad(prompts)
    want = np.asarray(jl.greedy_generate(
        params, cfg, jnp.asarray(ii), jnp.asarray(am), 6,
        llm.tokenizer.eos_token_id, llm.tokenizer.pad_token_id,
        cache_dtype=jnp.float32))
    from bergen_tpu_torch.models import llama as tl

    got = tl.greedy_generate(llm.params, llm.cfg, torch.from_numpy(ii),
                             torch.from_numpy(am), 6,
                             llm.tokenizer.eos_token_id,
                             llm.tokenizer.pad_token_id,
                             cache_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    B, S = ii.shape
    cache = jl.init_cache(cfg, B, S, dtype=jnp.float32)
    positions = jnp.maximum(jnp.cumsum(jnp.asarray(am), axis=1) - 1, 0)
    mask = jnp.tril(jnp.ones((S, S), bool))[None] & jnp.asarray(
        am)[:, None, :].astype(bool)
    logits, _ = jl.forward(params, cfg, jnp.asarray(ii), positions, cache,
                           mask)
    np.testing.assert_allclose(llm.first_token_logits(prompts),
                               np.asarray(logits[:, -1]), rtol=0,
                               atol=LOGITS_ATOL)
    assert llm.generate(prompts) == llm.tokenizer.batch_decode(
        want, skip_special_tokens=True)


def test_llm_gguf_composes_with_int4_and_serve(model):
    """The dequantized tree quantizes (int4, as JAX quantizes it) and
    serves, as a safetensors folder's does."""
    from bergen_tpu_torch.models.generators.llm import LLM

    folder, path, _ = model
    kw = dict(gguf_file=os.path.basename(path), max_new_tokens=3,
              max_length=64, device="cpu")
    q = LLM(str(folder), quantization="int4", **kw)
    assert "kernel_q4p" in q.params["layers"][0]["mlp"]["up"]
    prompts = ["what is the capital ?", "hello"]
    assert len(q.generate(prompts)) == 2
    static = LLM(str(folder), **kw).generate(prompts)
    assert LLM(str(folder), serve=True, max_slots=2,
               **kw).generate(prompts) == static


def test_llm_gguf_under_tp_ranks(model, tmp_path):
    """Two gloo ranks read the GGUF file and shard the dequantized tree:
    the static path's tokens and logits, and the servers' tokens, equal
    tp 1's."""
    import tp_ranks

    folder, path, _ = model
    kw = dict(gguf_file=os.path.basename(path), max_new_tokens=3,
              max_length=64)
    prompts, ids = ["what is the capital ?", "hello"], [[5, 6, 7], [9, 10]]
    two = tp_ranks.spawn(2, "generation", str(tmp_path / "ranks"),
                         model_name=str(folder), prompts=prompts, tp=2,
                         ids=ids, **kw)
    one = tp_ranks.generation(str(folder), prompts, 1, ids, **kw)
    for key in ("static", "epoch", "chunked", "epoch_ids", "paged"):
        assert two[key] == one[key], key
    np.testing.assert_allclose(two["logits"], one["logits"], rtol=0,
                               atol=1e-4)


def test_gorilla_config_through_the_cli(tmp_path, vocab):
    """``generator=gorilla-7b-hf-v1-gguf`` (its ``gguf_file`` name in a tiny
    model folder) through ``python -m bergen_tpu_torch`` on rag_ut1."""
    from test_torch_slice import REPO, _experiment
    from test_torch_slice_llama3_qwen2 import _overrides
    from tiny_models import build_tiny_bert

    folder = tmp_path / "gorilla"
    _write_model(folder, vocab, name="gorilla-7b-hf-v1-q6_K.gguf")
    models = {"bert": build_tiny_bert(str(tmp_path / "bert")),
              "gorilla": str(folder)}
    root = tmp_path / "torch"
    os.makedirs(root)
    env = dict(os.environ, CONFIG="rag_ut1", PYTHONPATH=REPO,
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "bergen_tpu_torch",
         *_overrides(root, models, "gorilla-7b-hf-v1-gguf", "gorilla"),
         "device=cpu"], cwd=root, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    exp = _experiment(root)
    with open(os.path.join(exp, "config.yaml")) as f:
        assert "gguf_file: gorilla-7b-hf-v1-q6_K.gguf" in f.read()
    rows = json.load(open(os.path.join(exp, "eval_dev_out.json")))
    assert len(rows) == 50 and all(isinstance(r["response"], str)
                                   for r in rows)
    metrics = json.load(open(os.path.join(exp, "eval_dev_metrics.json")))
    assert {"M", "EM", "F1"} <= set(metrics)
