"""Tensor parallelism on the CPU: the port's ``LLM(tp=...)`` as 2 and 4
ranks over gloo (``tests/tp_ranks.py``: spawned processes, one torch
thread each, a ``file://`` rendezvous in the test's folder) against the
JAX package's ``LLM(tp=...)`` on its 8-device host mesh and against the
port at tp 1, on ``tests/tiny_models.py``'s llama (4 heads, 2 KV heads,
vocabulary 1,400, so that the head is column-parallel):

* greedy tokens equal, f32 first-step logits within 1e-4;
* the epoch, chunked (chunks of 8) and paged servers token for token;
* int4 on a llama at hidden 512 (every projection quantized, the
  row-parallel slices whole groups; its head of 1,408 = 11 x 128 columns
  whole on every rank, as its 704 or 352 a rank are outside the int4
  kernel's shapes) tokens equal, JAX's int4 kernel on in interpret mode;
* at tp 4 the 2 KV heads are not divided: k and v stay whole and each rank
  keeps the head its query head reads;
* the shard/unshard round trip is bit for bit, on dense and int4 trees, and
  quantizing a slice gives the slice of the quantized tree;
* the concurrent-build lock: three processes build each source once.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

PROMPTS = [
    "user : what is the capital \n assistant : ",
    "user : tell me about the river bank and the fish \n assistant : ",
    "user : hello \n assistant : ",
    "user : a much longer question about many words that goes on \n "
    "assistant : ",
    "user : why \n assistant : ",
]
IDS = [[5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15], [9, 10],
       [11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27],
       [30, 31, 32]]
KW = dict(max_new_tokens=6, max_length=64, batch_size=4)
INT4_KW = dict(KW, max_new_tokens=3)  # JAX's int4 kernel runs interpreted
LOGITS_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch thread for this module (the suite runs several workers)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    from tiny_models import build_tiny_llama

    root = tmp_path_factory.mktemp("tp")
    return {"llama": build_tiny_llama(str(root / "llama"), vocab_extra=3),
            "int4": build_tiny_llama(str(root / "llama512"), hidden=512,
                                     vocab_extra=11)}


@pytest.fixture(scope="module")
def tp1(ckpts):
    import tp_ranks

    return tp_ranks.generation(ckpts["llama"], PROMPTS, 1, IDS,
                               int4_model=ckpts["int4"], **KW)


@pytest.fixture(scope="module", params=[2, 4], ids=["tp2", "tp4"])
def ranks(request, ckpts, tmp_path_factory):
    import tp_ranks

    tp = request.param
    return tp, tp_ranks.spawn(
        tp, "generation", str(tmp_path_factory.mktemp(f"ranks{tp}")),
        model_name=ckpts["llama"], prompts=PROMPTS, tp=tp, ids=IDS,
        int4_model=ckpts["int4"], **KW)


def _jax(ckpts, tp, **kw):
    from bergen_tpu.models.generators.jax_llm import LLM as JLLM

    return JLLM(ckpts["llama"], tp=tp, **KW, **kw)


def test_greedy_tokens_and_logits_match_jax_and_tp1(ranks, tp1, ckpts):
    tp, out = ranks
    assert out["cfg"].tp == tp and out["cfg"].num_heads == 4 // tp
    assert out["static"] == tp1["static"]
    np.testing.assert_allclose(out["logits"], tp1["logits"],
                               atol=LOGITS_ATOL, rtol=0)
    assert out["logits"].shape == (len(PROMPTS), 1400)  # gathered
    jllm = _jax(ckpts, tp)
    assert out["static"] == jllm.generate(PROMPTS)
    np.testing.assert_allclose(out["logits"],
                               jllm.first_token_logits(PROMPTS),
                               atol=LOGITS_ATOL, rtol=0)


@pytest.mark.parametrize("server", ["epoch", "chunked", "paged"])
def test_servers_token_for_token(ranks, tp1, ckpts, server):
    tp, out = ranks
    if server == "chunked":
        # the chunked drain is token-exact with the epoch drain
        assert out["chunked"] == tp1["chunked"] == out["epoch_ids"] \
            == tp1["epoch_ids"]
        jsrv = _jax(ckpts, tp, serve=True, max_slots=3).server
        assert out["chunked"] == jsrv.run_workload(IDS, 5, mode="chunked",
                                                   chunk_size=8)
        return
    assert out[server] == tp1[server] == tp1["static"]
    kv = {"kv_cache": "paged"} if server == "paged" else {}
    assert out[server] == _jax(ckpts, tp, serve=True, max_slots=3,
                               **kv).generate(PROMPTS)


def test_int4_tokens_match_jax_and_tp1(ranks, tp1, ckpts, monkeypatch):
    """JAX with its int4 kernel on (interpret mode), whose arithmetic the
    port's kernel and plain version share (x rounded to bf16)."""
    from bergen_tpu.models import llama as jllama
    from bergen_tpu.models.generators.jax_llm import LLM as JLLM

    monkeypatch.setattr(jllama, "USE_INT4_KERNEL", True)
    monkeypatch.setattr(jllama, "INT4_KERNEL_INTERPRET", True)
    tp, out = ranks
    assert out["int4_leaves"] == ["kernel_q4p", "kernel_scale4", "tp_shape"]
    assert out["int4_head"] == ["kernel_q4p", "kernel_scale4"]  # whole
    assert out["int4"] == tp1["int4"]
    assert out["int4"] == JLLM(ckpts["int4"], tp=tp, quantization="int4",
                               **INT4_KW).generate(PROMPTS)


def test_kv_heads_tp_does_not_divide_are_replicated(ranks):
    """2 KV heads over 4 ranks: k and v whole on every rank (JAX replicates
    them), each rank reading its one query head's KV head; over 2 ranks one
    head a rank."""
    from bergen_tpu_torch.parallel.shard import kept_kv_heads

    tp, out = ranks
    cfg = out["cfg"]  # rank 0's
    if tp == 4:
        assert cfg.kv_heads_kept == (0,) and cfg.num_kv_heads == 1
        assert [kept_kv_heads(4, 2, 4, r) for r in range(4)] == [
            (0,), (0,), (1,), (1,)]
    else:
        assert cfg.kv_heads_kept is None and cfg.num_kv_heads == 1
    # query heads that span KV groups unevenly: one KV head a query head
    assert kept_kv_heads(12, 3, 2, 1) == (1, 1, 2, 2, 2, 2)
    assert kept_kv_heads(8, 8, 4, 3) is None


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_unshard_round_trip(ckpts, tp):
    import torch

    from bergen_tpu_torch.models import convert, llama
    from bergen_tpu_torch.parallel import shard

    def equal(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                equal(a[k], b[k])
        elif isinstance(a, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                equal(x, y)
        else:
            assert a.dtype == b.dtype and torch.equal(a, b)

    for name in ("llama", "int4"):
        hf, sd = convert.load_checkpoint(ckpts[name])
        cfg = llama.LlamaConfig.from_hf(hf)
        params = convert.llama_from_hf(sd, cfg.num_layers)
        whole = convert.llama_from_hf(convert.load_checkpoint(ckpts[name])[1],
                                      cfg.num_layers)
        slices = [shard.shard_llama(params, cfg, tp, r)[0]
                  for r in range(tp)]
        equal(shard.unshard_llama(slices), whole)
        if name == "int4":
            q = convert.quantize_tree_int4(whole)
            sq = [convert.quantize_tree_int4(s) for s in slices]
            equal(shard.unshard_llama(sq), q)
            equal(shard.unshard_llama([shard.shard_llama(q, cfg, tp, r)[0]
                                       for r in range(tp)]), q)


def test_int4_slices_stay_inside_the_kernels_shapes():
    """At the tp configs' published widths (``chip_smoke.tp_int4_shards``:
    the shard rule on meta tensors, packed after slicing as ``LLM`` does)
    every int4 slice a rank launches is inside the kernels' shapes, and
    SOLAR's and Llama-2-70B's 32,000-column heads, whose slices over 4 and
    8 ranks are not (8,000 and 4,000 columns), stay whole.  At a small
    width the same head rule holds on a dense tree packed next and on a
    packed tree, a dense tree left dense is sliced, and a projection other
    than the head whose slice is outside raises."""
    import types

    import torch

    import chip_smoke
    from bergen_tpu_torch.models import convert, llama
    from bergen_tpu_torch.ops import int4_matmul as im
    from bergen_tpu_torch.parallel import shard

    shapes = chip_smoke.tp_int4_shards()
    assert len(shapes) == 17
    for K, N, Kw, Nw in shapes:
        assert im.supports(Kw, Nw, Kw // 128) and im.launchable(K, N, K // 128)
    heads = [s for s in shapes if s[3] == 32000]
    assert heads == [(5120, 16000, 5120, 32000), (4096, 32000, 4096, 32000),
                     (8192, 32000, 8192, 32000)]

    # d 512, vocabulary 640 = 5 x 128 columns: 160 a rank over 4
    cfg = llama.LlamaConfig.from_hf(types.SimpleNamespace(
        vocab_size=640, hidden_size=512, num_hidden_layers=1,
        num_attention_heads=4, num_key_value_heads=4, intermediate_size=512,
        max_position_embeddings=128, rms_norm_eps=1e-5, rope_theta=1e4))
    gen = torch.Generator().manual_seed(0)

    def tree():
        def lin(K, N):
            return {"kernel": torch.randn(K, N, generator=gen)}

        norm = {"scale": torch.ones(512)}
        return {"embed": torch.randn(640, 512, generator=gen),
                "final_norm": norm, "lm_head": lin(512, 640),
                "layers": [{"attn_norm": norm, "mlp_norm": norm,
                            "attn": {n: lin(512, 512) for n in "qkvo"},
                            "mlp": {n: lin(512, 512)
                                    for n in ("gate", "up", "down")}}]}

    dense = tree()
    packed = convert.quantize_tree_int4(tree())
    assert not im.launchable(512, 160, 4)
    for params, int4 in ((dense, True), (packed, False)):
        head = shard.shard_llama(params, cfg, 4, 1, int4=int4)[0]["lm_head"]
        assert "tp_shape" not in head
        for key, t in params["lm_head"].items():
            assert torch.equal(head[key], t)
    sliced = shard.shard_llama(dense, cfg, 4, 1)[0]["lm_head"]
    assert sliced["tp_shape"] == [512, 640]
    assert torch.equal(sliced["kernel"],
                       dense["lm_head"]["kernel"][:, 160:320])
    with pytest.raises(ValueError, match="outside the int4 kernels"):
        shard._column(packed["lm_head"], 4, 0, "layers.0.mlp.gate")
    assert shard._launches(packed["lm_head"], 5, False)  # 128 a rank


def test_build_lock_builds_each_source_once(tmp_path):
    """Three processes reach ``build_all`` together: each source compiles
    once (a stand-in nvcc counts its runs), and all three load it."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a", "b"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\necho run >> " + str(tmp_path / "runs") + "\nsleep 1\n"
        'while [ "$1" != "-o" ]; do shift; done\ntouch "$2"\n')
    nvcc.chmod(0o755)
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from bergen_tpu_torch.ops import _build\n"
        "_build.CSRC = %r; _build.BUILD_ROOT = %r\n"
        "print(_build.build_all())\n"
        % (os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
           str(csrc), str(tmp_path / "build")))
    env = dict(os.environ, PATH=f"{bin_dir}:{os.environ['PATH']}")
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=60)[0].strip() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert len(set(outs)) == 1
    assert sorted(os.listdir(outs[0])) == ["a.log", "a.so", "b.log", "b.so"]
    assert open(tmp_path / "runs").read().count("run") == 2


def test_mesh_rules_without_ranks(monkeypatch):
    """World 1 makes no process group; every rank on one named card needs
    gloo (NCCL refuses two ranks on one device); NCCL needs CUDA ranks;
    ``get_mesh`` keeps JAX's asserts, builds JAX's ``reshape(data,
    model)`` grid (model row d: ranks d*model..; data column m: the ranks
    with rank % model == m; a group each) and refuses a grid that leaves
    ranks out, naming Queue 1 #10; ``pad_batch_to_devices`` is JAX's."""
    import torch.distributed as dist

    from bergen_tpu.parallel import mesh as jmesh
    from bergen_tpu_torch.parallel import mesh

    m = mesh.init(device="cpu")
    assert (m.world, m.model, m.rank, str(m.device)) == (1, 1, 0, "cpu")
    assert not dist.is_initialized() and mesh.world_size() == 1
    for device, backend in (("cuda:0", None), ("cuda:0", "nccl"),
                            ("cpu", "nccl")):
        with pytest.raises(ValueError, match="NCCL|nccl"):
            mesh._rank_device(device, 1, backend)
    assert mesh._rank_device("cpu", 3, None) == (mesh.torch.device("cpu"),
                                                 "gloo")
    four = mesh.Mesh(1, 4, 0, 4, mesh.torch.device("cpu"), "gloo")
    monkeypatch.setattr(mesh, "_WORLD", four)
    monkeypatch.setattr(mesh, "_GRIDS", {})
    monkeypatch.setattr(mesh.dist, "new_group", tuple)  # its ranks
    monkeypatch.setattr(mesh.dist, "get_world_size", lambda: 4)
    monkeypatch.setattr(mesh.dist, "get_rank", lambda: 0)
    monkeypatch.setattr(mesh.dist, "is_initialized", lambda: True)
    assert mesh.get_mesh(model=4) is four is mesh.get_mesh(data=1, model=4)
    for data, model, err in ((None, 3, AssertionError),
                             (3, 2, AssertionError),
                             (1, 2, NotImplementedError),
                             (3, 1, NotImplementedError)):
        with pytest.raises(err, match=None if err is AssertionError
                           else "Queue 1 #10"):
            mesh.get_mesh(data, model)
    grid = mesh.get_mesh(model=2)
    assert grid is mesh.get_mesh(data=2, model=2)
    assert (grid.data, grid.model, grid.data_rank, grid.model_rank) == (
        2, 2, 0, 0)
    assert (grid.model_group, grid.data_group) == ((0, 1), (0, 2))
    three = mesh._grid(mesh.Mesh(1, 4, 3, 4, four.device, "gloo"), 2, 2)
    assert (three.data_rank, three.model_rank) == (1, 1)
    assert (three.model_group, three.data_group) == ((2, 3), (1, 3))
    data = mesh.get_mesh()  # the encoders' and retrieval's grid
    assert (data.data, data.model, data.model_group, data.data_group) == (
        4, 1, None, None)
    assert mesh.data_shard(1000, 128) == (1024, 0, 256)
    for n, shards in ((5, 4), (8, 4), (1, 3)):
        x = np.arange(n * 3).reshape(n, 3)
        got, gn = mesh.pad_batch_to_devices(x, shards)
        want, wn = jmesh.pad_batch_to_devices(x, shards)
        assert gn == wn and np.array_equal(got, want)
