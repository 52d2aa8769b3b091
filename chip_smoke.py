"""On-card smoke run of the PyTorch/CUDA port (bergen_tpu_torch).

    python3 chip_smoke.py            # one GPU

Phases (each prints one JSON line):
  1. the card (nvidia-smi name and power limit) and the kernel build time;
  2. two seeded random-weight HF checkpoints at full published widths:
     BERT-base (bge-base-en-v1.5) and TinyLlama-1.1B-Chat, with tokenizers
     over the tests/utdata vocabulary, written by the port's own writers;
  3. each hand-written kernel against its plain PyTorch version at the main
     path's shapes: max error against a stated tolerance, kernel / plain /
     library time and the card's lower bound for the same work;
  4. the main path: ``python -m bergen_tpu_torch`` (the rag_ut1 config, dense
     retriever, TinyLlama generator) on dataset ut1 with the two checkpoints,
     then the same models on the card against the port's f32 CPU path on a
     small input (64 docs, two questions: prefill and one decode step);
  5. retrieval at scale: ``Retrieve.retrieve`` over 262,144 synthetic
     unit-norm fp16 shards with topk_method auto (takes the fused kernel);
  6. one ``kernels`` line with every kernel's numbers and launch counts.
The last line is {"ok": true, "device": {...}}.  Any failure exits non-zero
before it.  Kernel launch counts are zeroed just before each part of the
main path (the ut1 eval of phase 4, the retrieval of phase 5) and read just
after it, so the comparisons of phase 3 do not count; a kernel that a part
runs must show launches there.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak
PEAK_F32_FLOPS = 67e12     # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3

KERNELS = {
    "encoder_layer": {
        "route": "cuda", "source": "bergen_tpu_torch/csrc/encoder_layer.cu",
        "replaces": "bergen_tpu/ops/encoder_attention.py:710"},
    "bin_topk": {
        "route": "cuda", "source": "bergen_tpu_torch/csrc/bin_topk.cu",
        "replaces": "bergen_tpu/ops/fused_topk.py:145"},
    "decode_attention": {
        "route": "cuda", "source": "bergen_tpu_torch/csrc/decode_attention.cu",
        "replaces": "bergen_tpu/ops/decode_attention.py:115"},
}
# the kernels each part of the main path must launch: ut1's 1,000 docs are
# below the fused top-k's 131,072-doc threshold, and the at-scale retrieval
# reads precomputed embeddings and generates nothing
PATH_KERNELS = {"ut1_eval": ("encoder_layer", "decode_attention"),
                "retrieval_at_scale": ("bin_topk",)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")


# --------------------------------------------------------------------------- #
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------- #


def library_encoder_layer(w: dict, num_heads: int, eps: float):
    """PyTorch's own post-LN encoder layer (erf GELU) holding the weights of
    ``fuse_layer``'s dict: in eval mode without grad its forward is one call
    of the fused ``torch._transformer_encoder_layer_fwd``.  A yardstick for
    ``library_ms`` only; the port never calls it."""
    import torch

    D, I = w["w1"].shape
    dt, dev = w["w1"].dtype, w["w1"].device
    m = torch.nn.TransformerEncoderLayer(
        D, num_heads, I, dropout=0.0, activation="gelu", layer_norm_eps=eps,
        batch_first=True, norm_first=False, device=dev, dtype=dt).eval()
    with torch.no_grad():
        for p, src in ((m.self_attn.in_proj_weight, w["wqkv"].T),
                       (m.self_attn.in_proj_bias, w["bqkv"]),
                       (m.self_attn.out_proj.weight, w["wo"].T),
                       (m.self_attn.out_proj.bias, w["bo"]),
                       (m.norm1.weight, w["ln1_s"]), (m.norm1.bias, w["ln1_b"]),
                       (m.linear1.weight, w["w1"].T), (m.linear1.bias, w["b1"]),
                       (m.linear2.weight, w["w2"].T), (m.linear2.bias, w["b2"]),
                       (m.norm2.weight, w["ln2_s"]),
                       (m.norm2.bias, w["ln2_b"])):
            p.copy_(src)

    def run(x, mask):
        with torch.inference_mode():
            return m(x, src_key_padding_mask=mask == 0)

    return run


def check_encoder_layer(results: dict, dev) -> None:
    import torch
    from bergen_tpu_torch.ops import encoder_attention as ea

    D, H, I, eps, act = 768, 12, 3072, 1e-12, "gelu"
    gen = torch.Generator(device=dev).manual_seed(1)

    def rnd(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * std

    layer = {
        "attn": {n: {"kernel": rnd(D, D, std=0.02).bfloat16(),
                     "bias": rnd(D, std=0.02)} for n in "qkvo"},
        "attn_ln": {"scale": 1 + rnd(D, std=0.1), "bias": rnd(D, std=0.1)},
        "mlp_in": {"kernel": rnd(D, I, std=0.02).bfloat16(),
                   "bias": rnd(I, std=0.02)},
        "mlp_out": {"kernel": rnd(I, D, std=0.02).bfloat16(),
                    "bias": rnd(D, std=0.02)},
        "mlp_ln": {"scale": 1 + rnd(D, std=0.1), "bias": rnd(D, std=0.1)},
    }
    w = ea.fuse_layer(layer)
    library = library_encoder_layer(w, H, eps)
    # bf16 rounding of qkv / probabilities / ctx / FFN hidden flips with the
    # summation order: the max is two bf16 ulps of the largest outputs (|y|
    # in [4, 8)), the mean a few ulps of a typical |y| ~ 1
    tol, mean_tol = 0.0625, 2e-3
    per_shape = []
    # a full doc batch at S 128 and S 512 (the kernels line reports the
    # first), then the ut1 run's own buckets: 512 docs at S 64, 50 queries
    # at S 32
    for B, S in ((512, 128), (512, 512), (512, 64), (50, 32)):
        x = rnd(B, S, D).bfloat16()
        lens = torch.randint(1, S + 1, (B,), generator=gen, device=dev)
        lens[0] = S
        mask = (torch.arange(S, device=dev)[None, :] < lens[:, None]).int()
        mask[1] = 0  # a fully masked row
        out = ea.encoder_layer(x, w, mask, H, eps, act)
        ref = ea.encoder_layer_plain(x, w, mask, H, eps, act)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        max_err, mean_err = err.max().item(), err.mean().item()
        if not torch.isfinite(out.float()).all():
            fail(f"encoder_layer B{B} S{S}: non-finite output")
        ms = cuda_time_ms(lambda: ea.encoder_layer(x, w, mask, H, eps, act))
        plain_ms = cuda_time_ms(
            lambda: ea.encoder_layer_plain(x, w, mask, H, eps, act), iters=2,
            warmup=1)
        # the library layer's agreement, for the record: the fully masked
        # row is left out (PyTorch gives it no defined value)
        lib_err = (library(x, mask).float() - ref.float())[mask.any(1)] \
            .abs().max().item()
        library_ms = cuda_time_ms(lambda: library(x, mask))
        M = B * S
        flops = 2 * M * D * (4 * D + 2 * I) + 4 * B * H * S * S * (D // H)
        nbytes = 2 * M * D * 2 + (4 * D * D + 2 * D * I) * 2 + B * S * 4
        b_ms, b_by = bound(flops, nbytes)
        row = {"B": B, "S": S, "max_abs_err": max_err, "mean_abs_err": mean_err,
               "tol": tol, "mean_tol": mean_tol, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": library_ms,
               "library_max_abs_err": lib_err}
        emit({"phase": "kernel_check", "kernel": "encoder_layer", **row})
        per_shape.append(row)
        if not (max_err <= tol and mean_err <= mean_tol):
            fail(f"encoder_layer B{B} S{S}: max error {max_err} (tol {tol}), "
                 f"mean error {mean_err} (tol {mean_tol})")
        del x, out, ref, err
        torch.cuda.empty_cache()
    results["encoder_layer"] = per_shape


def check_bin_topk(results: dict, dev) -> None:
    import torch
    from bergen_tpu_torch.ops import fused_topk as ft

    N, D, Q, k = 262_144, 768, 2_048, 50
    gen = torch.Generator(device=dev).manual_seed(2)
    corpus = torch.nn.functional.normalize(
        torch.randn(N, D, generator=gen, device=dev), dim=1).bfloat16()
    queries = torch.nn.functional.normalize(
        torch.randn(Q, D, generator=gen, device=dev), dim=1).bfloat16()
    valid_n = N - 1000  # the tail is padding: it must never win
    vals, idx = ft.bin_scores(queries, corpus, valid_n)
    rv, ri = ft.bin_scores_plain(queries, corpus, valid_n)
    torch.cuda.synchronize()
    tol = 1e-4  # f32 sums of 768 bf16 products in another order
    finite = torch.isfinite(rv)
    max_err = (vals[finite] - rv[finite]).abs().max().item()
    if not torch.equal(torch.isfinite(vals), finite):
        fail("bin_topk: masked bins disagree")
    # an index may differ only where two docs of a bin tie within tol
    s = corpus.float() @ queries.float().T
    s[valid_n:] = float("-inf")
    picked = s.gather(0, idx.long().clamp_max(N - 1))
    bad = ((picked - rv).abs() > tol) & finite
    n_idx_diff = int((idx != ri).sum().item())
    del s, picked
    v2, i2 = ft.bin_topk(queries, corpus, k, valid_n=valid_n)
    if int((i2 >= valid_n).sum().item()):
        fail("bin_topk: a padding doc was returned")
    ms = cuda_time_ms(lambda: ft.bin_scores(queries, corpus, valid_n))
    plain_ms = cuda_time_ms(
        lambda: ft.bin_scores_plain(queries, corpus, valid_n), iters=3)

    def library():
        sc = torch.matmul(corpus, queries.T).view(-1, ft.BIN, Q)
        return sc.amax(dim=1), sc.argmax(dim=1)

    library_ms = cuda_time_ms(library, iters=5)
    n_bins = N // ft.BIN
    b_ms, b_by = bound(2 * N * Q * D, N * D * 2 + Q * D * 2 + n_bins * Q * 8)
    row = {"N": N, "D": D, "Q": Q, "k": k, "max_abs_err": max_err, "tol": tol,
           "index_diffs": n_idx_diff, "index_diffs_beyond_tol":
           int(bad.sum().item()), "ms": ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}
    emit({"phase": "kernel_check", "kernel": "bin_topk", **row})
    if not max_err <= tol or row["index_diffs_beyond_tol"]:
        fail(f"bin_topk: max error {max_err} (tol {tol}), "
             f"{row['index_diffs_beyond_tol']} indices off beyond tol")
    results["bin_topk"] = [row]


def check_decode_attention(results: dict, dev) -> None:
    import torch
    from bergen_tpu_torch.ops import decode_attention as da

    B, H, Dh = 8, 32, 64
    gen = torch.Generator(device=dev).manual_seed(3)
    tol = 2e-3  # a few bf16 ulps of the outputs (|out| ~ 0.05 at L 2,112)
    per_shape = []
    # TinyLlama's group 8 (KH 4) at both cache lengths (the kernels line
    # reports the first), then every other group the kernel is built for
    for KH, L in ((4, 320), (4, 2112), (8, 320), (16, 320), (32, 320)):
        q = torch.randn(B, H, Dh, generator=gen, device=dev).bfloat16()
        kc = torch.randn(B, L, KH * Dh, generator=gen, device=dev).bfloat16()
        vc = torch.randn(B, L, KH * Dh, generator=gen, device=dev).bfloat16()
        start = torch.randint(0, L // 2, (B,), generator=gen, device=dev)
        stop = torch.randint(L // 2, L + 1, (B,), generator=gen, device=dev)
        pos = torch.arange(L, device=dev)[None, :]
        valid = (pos >= start[:, None]) & (pos < stop[:, None])
        valid[1] = False  # a fully masked row: uniform mean of V
        scale = 1.0 / math.sqrt(Dh)
        out = da.decode_attention(q, kc, vc, valid, kv_heads=KH,
                                  sm_scale=scale)
        ref = da.decode_attention_plain(q, kc, vc, valid, kv_heads=KH,
                                        sm_scale=scale)
        torch.cuda.synchronize()
        max_err = (out.float() - ref.float()).abs().max().item()
        ms = cuda_time_ms(lambda: da.decode_attention(
            q, kc, vc, valid, kv_heads=KH, sm_scale=scale), iters=50)
        plain_ms = cuda_time_ms(lambda: da.decode_attention_plain(
            q, kc, vc, valid, kv_heads=KH, sm_scale=scale), iters=20)
        k4 = kc.view(B, L, KH, Dh).transpose(1, 2)
        v4 = vc.view(B, L, KH, Dh).transpose(1, 2)
        amask = valid[:, None, None, :]
        q4 = q[:, :, None, :]
        library_ms = cuda_time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=amask, scale=scale, enable_gqa=True),
            iters=50)
        nbytes = 2 * B * L * KH * Dh * 2 + 2 * B * H * Dh * 2 + B * L
        b_ms, b_by = bound(4 * B * H * L * Dh, nbytes, PEAK_F32_FLOPS)
        row = {"B": B, "L": L, "H": H, "KH": KH, "max_abs_err": max_err,
               "tol": tol, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": library_ms}
        emit({"phase": "kernel_check", "kernel": "decode_attention", **row})
        per_shape.append(row)
        if not max_err <= tol:
            fail(f"decode_attention KH{KH} L{L}: max error {max_err} > {tol}")
    results["decode_attention"] = per_shape


# --------------------------------------------------------------------------- #
# phase 2: full-width random-weight checkpoints
# --------------------------------------------------------------------------- #

BERT_BASE = dict(model_type="bert", vocab_size=30522, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, max_position_embeddings=512,
                 type_vocab_size=2, layer_norm_eps=1e-12, hidden_act="gelu",
                 pad_token_id=0, position_embedding_type="absolute")
TINYLLAMA = dict(model_type="llama", vocab_size=32000, hidden_size=2048,
                 num_hidden_layers=22, num_attention_heads=32,
                 num_key_value_heads=4, intermediate_size=5632,
                 max_position_embeddings=2048, rope_theta=10000.0,
                 rms_norm_eps=1e-5, tie_word_embeddings=False,
                 hidden_act="silu", bos_token_id=1, eos_token_id=2)
# TinyLlama-1.1B-Chat-v1.0's chat template (zephyr style)
ZEPHYR_TEMPLATE = (
    "{% for message in messages %}\n{% if message['role'] == 'user' %}\n"
    "{{ '<|user|>\n' + message['content'] + eos_token }}\n"
    "{% elif message['role'] == 'system' %}\n"
    "{{ '<|system|>\n' + message['content'] + eos_token }}\n"
    "{% elif message['role'] == 'assistant' %}\n"
    "{{ '<|assistant|>\n'  + message['content'] + eos_token }}\n"
    "{% endif %}\n{% if loop.last and add_generation_prompt %}\n"
    "{{ '<|assistant|>' }}\n{% endif %}\n{% endfor %}")


def _fixture_words() -> list[str]:
    words = set()
    for name in ("ut1_docs.tsv", "ut1_queries.tsv"):
        with open(os.path.join(REPO, "tests", "utdata", name)) as f:
            for line in f:
                for tok in line.lower().replace("\t", " ").split():
                    words.add(tok.strip(".,?!"))
    return sorted(w for w in words if w)


def _vocab(specials: dict[str, int], size: int, filler: str) -> dict:
    vocab = dict(specials)
    nxt = max(specials.values()) + 1
    for w in _fixture_words():
        if w not in vocab:
            vocab[w] = nxt
            nxt += 1
    for i in range(nxt, size):
        vocab[filler.format(i)] = i
    return vocab


def write_checkpoints(root: str, dev) -> dict:
    """Seeded random bf16 weights at the published widths of
    BAAI/bge-base-en-v1.5 (BERT-base) and TinyLlama-1.1B-Chat-v1.0."""
    import torch
    from bergen_tpu_torch.models.convert import save_safetensors
    from bergen_tpu_torch.models.tokenizer import write_tokenizer

    gen = torch.Generator(device=dev).manual_seed(0)

    def w(*shape, std=0.02):
        return (torch.randn(*shape, generator=gen, device=dev) * std
                ).bfloat16().cpu()

    def ones(n):
        return torch.ones(n, dtype=torch.bfloat16)

    def zeros(n):
        return torch.zeros(n, dtype=torch.bfloat16)

    out = {}
    bert_dir = os.path.join(root, "bge-base-en-v1.5-random")
    os.makedirs(bert_dir, exist_ok=True)
    c = BERT_BASE
    D, I = c["hidden_size"], c["intermediate_size"]
    sd = {"embeddings.word_embeddings.weight": w(c["vocab_size"], D),
          "embeddings.position_embeddings.weight": w(512, D),
          "embeddings.token_type_embeddings.weight": w(2, D),
          "embeddings.LayerNorm.weight": ones(D),
          "embeddings.LayerNorm.bias": zeros(D)}
    for i in range(c["num_hidden_layers"]):
        pre = f"encoder.layer.{i}"
        for name, (o, n) in {"attention.self.query": (D, D),
                             "attention.self.key": (D, D),
                             "attention.self.value": (D, D),
                             "attention.output.dense": (D, D),
                             "intermediate.dense": (I, D),
                             "output.dense": (D, I)}.items():
            sd[f"{pre}.{name}.weight"] = w(o, n)
            sd[f"{pre}.{name}.bias"] = zeros(o)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[f"{pre}.{name}.weight"] = ones(D)
            sd[f"{pre}.{name}.bias"] = zeros(D)
    save_safetensors(sd, os.path.join(bert_dir, "model.safetensors"))
    with open(os.path.join(bert_dir, "config.json"), "w") as f:
        json.dump(c, f, indent=2)
    specials = {"[PAD]": 0, "[UNK]": 100, "[CLS]": 101, "[SEP]": 102,
                "[MASK]": 103}
    vocab = _vocab(specials, c["vocab_size"], "[unused{}]")
    write_tokenizer(bert_dir, "WordPiece", vocab,
                    {"pad_token": "[PAD]", "unk_token": "[UNK]",
                     "cls_token": "[CLS]", "sep_token": "[SEP]",
                     "mask_token": "[MASK]"},
                    lowercase=True, strip_accents=True,
                    template=("[CLS]", "[SEP]"))
    out["bert"] = bert_dir
    del sd

    llama_dir = os.path.join(root, "tinyllama-1.1b-chat-random")
    os.makedirs(llama_dir, exist_ok=True)
    c = TINYLLAMA
    D, I, V = c["hidden_size"], c["intermediate_size"], c["vocab_size"]
    KV = c["num_key_value_heads"] * D // c["num_attention_heads"]
    sd = {"model.embed_tokens.weight": w(V, D), "model.norm.weight": ones(D),
          "lm_head.weight": w(V, D)}
    for i in range(c["num_hidden_layers"]):
        pre = f"model.layers.{i}"
        for name, (o, n) in {"self_attn.q_proj": (D, D),
                             "self_attn.k_proj": (KV, D),
                             "self_attn.v_proj": (KV, D),
                             "self_attn.o_proj": (D, D),
                             "mlp.gate_proj": (I, D), "mlp.up_proj": (I, D),
                             "mlp.down_proj": (D, I)}.items():
            sd[f"{pre}.{name}.weight"] = w(o, n)
        sd[f"{pre}.input_layernorm.weight"] = ones(D)
        sd[f"{pre}.post_attention_layernorm.weight"] = ones(D)
    save_safetensors(sd, os.path.join(llama_dir, "model.safetensors"))
    with open(os.path.join(llama_dir, "config.json"), "w") as f:
        json.dump(c, f, indent=2)
    vocab = _vocab({"<unk>": 0, "<s>": 1, "</s>": 2}, V, "<extra_{}>")
    write_tokenizer(llama_dir, "WordLevel", vocab,
                    {"bos_token": "<s>", "eos_token": "</s>",
                     "unk_token": "<unk>"},
                    lowercase=True, chat_template=ZEPHYR_TEMPLATE)
    out["llama"] = llama_dir
    return out


# --------------------------------------------------------------------------- #
# phases 4 and 5: the main path
# --------------------------------------------------------------------------- #


def run_main_path(ckpt: dict, workdir: str) -> dict:
    """``python -m bergen_tpu_torch`` (CONFIG=rag_ut1) in this process, so
    the kernels' launch counters can be read afterwards."""
    import runpy

    overrides = [
        "dataset=ut1", "retriever=bge-base-en-v1.5",
        f"retriever.init_args.model_name={ckpt['bert']}",
        "generator=tinyllama-chat",
        f"generator.init_args.model_name={ckpt['llama']}",
        f"qrels_folder={os.path.join(REPO, 'tests', 'utdata')}",
    ]
    old = (sys.argv, os.getcwd(), os.environ.get("CONFIG"))
    os.environ["CONFIG"] = "rag_ut1"
    os.chdir(workdir)
    sys.argv = ["bergen_tpu_torch", *overrides]
    t0 = time.perf_counter()
    try:
        runpy.run_module("bergen_tpu_torch", run_name="__main__",
                         alter_sys=True)
    finally:
        sys.argv = old[0]
        os.chdir(old[1])
        if old[2] is None:
            os.environ.pop("CONFIG")
        else:
            os.environ["CONFIG"] = old[2]
    wall = time.perf_counter() - t0
    exp_root = os.path.join(workdir, "tests", "run", "experiments")
    exps = [d for d in os.listdir(exp_root) if not d.startswith("tmp_")]
    if len(exps) != 1:
        fail(f"main path: expected one finished experiment, got {exps}")
    exp = os.path.join(exp_root, exps[0])
    with open(os.path.join(exp, "eval_dev_out.json")) as f:
        rows = json.load(f)
    with open(os.path.join(exp, "eval_dev_metrics.json")) as f:
        metrics = json.load(f)
    with open(os.path.join(exp, "eval_dev_stage_times.json")) as f:
        stages = json.load(f)
    trec = [n for n in os.listdir(exp) if n.startswith("run.retrieve.")]
    if not trec:
        fail("main path: no TREC run in the experiment folder")
    with open(os.path.join(exp, trec[0])) as f:
        lines = [ln.split("\t") for ln in f.read().splitlines()]
    scores = [float(ln[4]) for ln in lines]
    if len(rows) != 50 or len(lines) != 50 * 10:
        fail(f"main path: {len(rows)} outputs, {len(lines)} TREC lines "
             "(expected 50 and 500)")
    if not all(math.isfinite(s) and -1.0001 <= s <= 1.0001 for s in scores):
        fail("main path: TREC scores not finite cosines")
    if not all(isinstance(r["response"], str) for r in rows):
        fail("main path: responses are not strings")
    if not {"M", "EM", "F1", "Recall_char3gram"} <= set(metrics):
        fail(f"main path: metrics file lacks keys: {sorted(metrics)}")
    return {"wall_s": wall, "stage_s": stages, "n_outputs": len(rows),
            "trec_lines": len(lines), "metrics": metrics,
            "example_response": rows[0]["response"][:80]}


def _cos_rows(a, b) -> float:
    """Smallest cosine similarity between matching rows of a and b."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    cos = np.sum(a * b, axis=1) / (np.linalg.norm(a, axis=1)
                                    * np.linalg.norm(b, axis=1))
    return float(np.min(cos))


def check_against_cpu(ckpt: dict) -> dict:
    """The card's bf16 path against the port's f32 CPU path (every kernel's
    plain version) on a small input at full width: 64 ut1 docs through the
    retriever (encoder layer), and the prefill plus one decode step
    (decode attention) of the generator on two ut1 questions."""
    import torch
    from bergen_tpu_torch.models import llama
    from bergen_tpu_torch.models.generators.llm import LLM
    from bergen_tpu_torch.models.retrievers.dense import DenseRetriever

    tol = 0.99  # min cosine, bf16 against f32
    with open(os.path.join(REPO, "tests", "utdata", "ut1_docs.tsv")) as f:
        docs = [ln.split("\t")[1] for ln in f][:64]
    with open(os.path.join(REPO, "tests", "utdata", "ut1_queries.tsv")) as f:
        questions = [ln.split("\t")[1] for ln in f][:2]
    kw = dict(max_len=512, pooler="cls", similarity="cos")
    enc = [DenseRetriever(ckpt["bert"], device=d, dtype=t, **kw).encode(
        docs, "doc") for d, t in (("cuda", None), ("cpu", "f32"))]

    logits = {}
    tok = None
    for dev, dtype in (("cuda", None), ("cpu", "f32")):
        llm = LLM(ckpt["llama"], device=dev, dtype=dtype)
        ii, am = llm._tokenize_left_pad(questions)
        ids = torch.from_numpy(ii).to(llm.device)
        mask = torch.from_numpy(am).to(llm.device).bool()
        B, S = ii.shape
        cache = llama.init_cache(llm.cfg, B, S + 1, dtype=llm.dtype,
                                 device=llm.device)
        pos = (mask.long().cumsum(1) - 1).clamp_min(0)
        causal = torch.tril(torch.ones(S, S, dtype=torch.bool,
                                       device=llm.device))
        with torch.inference_mode():
            pre = llama.forward(llm.params, llm.cfg, ids, pos, cache,
                                causal[None] & mask[:, None, :],
                                last_only=True)[:, -1]
            if tok is None:  # both devices decode the card's first token
                tok = pre.argmax(dim=-1).cpu()
            valid = torch.cat([mask, torch.ones(B, 1, dtype=torch.bool,
                                                device=llm.device)], dim=1)
            step = llama.forward(llm.params, llm.cfg,
                                 tok[:, None].to(llm.device), pos[:, -1:] + 1,
                                 cache, valid[:, None, :])[:, -1]
        logits[dev] = (pre.float().cpu().numpy(), step.float().cpu().numpy())
        del llm, cache
    out = {"encoder_min_cos": _cos_rows(*enc),
           "prefill_logits_min_cos": _cos_rows(logits["cuda"][0],
                                               logits["cpu"][0]),
           "decode_logits_min_cos": _cos_rows(logits["cuda"][1],
                                              logits["cpu"][1]),
           "tol": tol}
    bad = [k for k, v in out.items() if k != "tol" and not v >= tol]
    if bad:
        fail(f"card vs CPU reference: {bad} below {tol}: {out}")
    return out


def run_retrieval_at_scale(ckpt: dict, workdir: str) -> dict:
    """Retrieve.retrieve over 262,144 unit-norm fp16 doc shards (D 768)
    with topk_method auto: 2,048 queries, each a noisy copy of one doc."""
    import numpy as np
    from bergen_tpu_torch.data.dataset import Dataset
    from bergen_tpu_torch.pipeline.retrieve import CHUNK_DOCS, Retrieve

    N, D, Q, k = 262_144, 768, 2_048, 50
    rng = np.random.default_rng(5)
    docs = rng.standard_normal((N, D), dtype=np.float32)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    src = rng.choice(N, size=Q, replace=False)
    qry = docs[src] + 0.05 * rng.standard_normal((Q, D), dtype=np.float32)
    qry /= np.linalg.norm(qry, axis=1, keepdims=True)
    d_path = os.path.join(workdir, "scale_index", "doc")
    q_path = os.path.join(workdir, "scale_index", "query")
    os.makedirs(d_path)
    os.makedirs(q_path)
    for c, s in enumerate(range(0, N, CHUNK_DOCS)):
        np.save(os.path.join(d_path, f"embedding_chunk_{c}.npy"),
                docs[s:s + CHUNK_DOCS].astype(np.float16))
    np.save(os.path.join(q_path, "embedding_chunk_0.npy"),
            qry.astype(np.float16))
    dataset = {
        "query": Dataset.from_dict({"id": [f"q{i}" for i in range(Q)],
                                    "content": ["-"] * Q}),
        "doc": Dataset.from_dict({"id": [f"d{i}" for i in range(N)],
                                  "content": ["-"] * N}),
    }
    init_args = {
        "_target_": "bergen_tpu.models.retrievers.dense.DenseRetriever",
        "model_name": ckpt["bert"], "max_len": 512, "pooler": "cls",
        "similarity": "cos"}
    ret = Retrieve(init_args=init_args, batch_size=512, batch_size_sim=2048,
                   topk_method="auto")
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ret.retrieve(dataset, q_path, d_path, k)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fid = out.get("fidelity", [])
    if not fid or any(f["method"] != "fused" for f in fid):
        fail(f"retrieval at scale: a batch left the fused path ({fid})")
    top1 = np.array([int(row[0][1:]) for row in out["doc_id"]])
    top1_hit = float(np.mean(top1 == src))
    scores = np.asarray(out["score"])
    if scores.shape != (Q, k) or not np.isfinite(scores).all():
        fail(f"retrieval at scale: scores {scores.shape} not finite")
    if top1_hit < 0.99:
        fail(f"retrieval at scale: top-1 is the source doc for only "
             f"{top1_hit:.4f} of queries")
    return {"N": N, "D": D, "Q": Q, "k": k, "wall_s": wall,
            "fidelity": fid, "top1_is_source": top1_hit}


# --------------------------------------------------------------------------- #
# entry point
# --------------------------------------------------------------------------- #


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, REPO)
    from bergen_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    t0 = time.perf_counter()
    _build.build_all()
    emit({"phase": "build", "card": card,
          "build_s": time.perf_counter() - t0,
          "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda})

    from bergen_tpu_torch.ops import decode_attention as da
    from bergen_tpu_torch.ops import encoder_attention as ea
    from bergen_tpu_torch.ops import fused_topk as ft

    counters = {"encoder_layer": ea.encoder_layer,
                "bin_topk": ft.bin_scores,
                "decode_attention": da.decode_attention}
    results: dict = {}
    check_encoder_layer(results, dev)
    check_bin_topk(results, dev)
    check_decode_attention(results, dev)
    torch.cuda.empty_cache()

    root = os.path.join(REPO, "bergen_tpu_torch", "_build", "checkpoints")
    t0 = time.perf_counter()
    ckpt = write_checkpoints(root, dev)
    emit({"phase": "checkpoints", "write_s": time.perf_counter() - t0,
          **ckpt})
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    by_path: dict = {}
    try:
        for path, run in (("ut1_eval", run_main_path),
                          ("retrieval_at_scale", run_retrieval_at_scale)):
            for fn in counters.values():
                fn.launches = 0
            emit({"phase": path, **run(ckpt, work)})
            by_path[path] = {n: fn.launches for n, fn in counters.items()}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "launches", **by_path})
    idle = [f"{n} on {path}" for path, names in PATH_KERNELS.items()
            for n in names if by_path[path][n] == 0]
    if idle:
        fail(f"kernels never launched where the path runs them: {idle}")
    emit({"phase": "reference_check", **check_against_cpu(ckpt)})

    line = []
    for name, meta in KERNELS.items():
        row = results[name][0]
        per_path = {path: c[name] for path, c in by_path.items()}
        line.append({"name": name, **meta,
                     "launches": sum(per_path.values()),
                     "launches_by_path": per_path,
                     **{key: row[key] for key in (
                         "max_abs_err", "ms", "plain_ms", "bound_ms",
                         "bound_by", "library_ms")}})
    emit({"kernels": line})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
