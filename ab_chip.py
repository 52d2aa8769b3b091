"""Same-host A/B of the port's source trees on one GPU.

    python3 ab_chip.py decode_attention TREE [TREE ...]
    python3 ab_chip.py kernels TREE [TREE ...]
    python3 ab_chip.py attention TREE [TREE ...]
    python3 ab_chip.py paths TREE [TREE ...]
    python3 ab_chip.py w8a8 TREE [TREE ...]
    python3 ab_chip.py score_paged TREE [TREE ...]
    python3 ab_chip.py serve_paged TREE [TREE ...]
    python3 ab_chip.py band_int8 TREE [TREE ...]
    python3 ab_chip.py serve_chunked TREE [TREE ...]
    python3 ab_chip.py sass TREE TREE

A TREE is ``.`` (this checkout) or a directory that holds another version
of ``bergen_tpu_torch/``, ``config/`` and ``tests/utdata/``, for example
unpacked from ``git archive <commit> bergen_tpu_torch config tests/utdata``
into a directory that ``.gitignore`` lists.  Each TREE in turn, in the
order given and in a process of its own that imports the package from that
tree (its kernels built there), runs one of this checkout's
``chip_smoke.py`` phases:

* ``decode_attention``: ``check_decode_attention`` (the kernel against its
  plain version at every decode shape, with its warm, L2-cold and
  profiler device times);
* ``kernels``: ``check_encoder_layer`` and ``check_bin_topk`` (the bf16
  GEMM chain of the encoder layer at its five shapes, with the card's own
  time of each of its seven launches, and the bin top-k of mode 'none');
* ``attention``: ``check_flash_attention`` and ``check_encoder_attention``
  (the causal prefill at every flash shape and the rope/ALiBi encoders'
  attention at every encoder shape, against their plain versions, with
  the library call's time beside each); the kernels a call are counted
  only for this checkout's tree (an older tree's flash wrapper converts
  the mask in a launch of its own);
* ``w8a8``: ``check_encoder_layer_q`` (the W8A8 layer at its seven
  shapes, with the card's own time of each launch of its chain, the kernels
  a call and ``torch._int_mm``'s time for the four products alone);
* ``score_paged``: ``check_pallas_score`` and ``check_paged_attention``
  (the score GEMM at the retrieval shapes with ``torch.mm``'s time beside
  it, and the paged partial in the ut1-like and ragged cases, each with
  the card's own time, the kernels a call and, on this checkout's tree,
  the splits chosen);
* ``band_int8``: ``check_flash_attention_band`` and
  ``check_bin_topk_int8`` (the band attention at the chunked drain's
  shapes and the int8 bin top-k in modes 'bin' and 'doc' at the retrieval
  shape, each with its event and profiler card times, the library call's
  and the kernels a call, and the int8 modes' saturated case bit for bit);
* ``paths``: the ut1_eval and ut1_int4_llama2 runs of ``python -m
  bergen_tpu_torch`` (stage times), on checkpoints that this process
  writes once, before the first tree, and deletes at the end;
* ``serve_paged``: the ut1_serve_mistral run with ``kv_cache=paged``,
  then with the uniform cache (decode steps, paged kernel launches a
  step, the 50 answers and their digest, stage times), on checkpoints
  written the same way; then ``compare_answers``: how many answers
  differ between the first two trees in each mode, and between the
  modes in each tree;
* ``serve_chunked``: the ut1_serve_mistral run (uniform cache), then its
  50 instructions drained with ``run_workload(mode="chunked")`` and
  ``mode="epoch"`` (new tokens/s of each, band launches and pipe-steps,
  a digest of each mode's tokens), on checkpoints written the same way.

``sass`` compiles each ``csrc/*.cu`` of the two trees to a cubin
(``nvcc -cubin``, the build's target and flags) and compares their SASS
function by function, with addresses, encodings and function names left
out: one line a source, ``identical`` when every function's instructions
are (the proof that an edit to shared code leaves a kernel as it was), and
how many of the first tree's functions the second has unchanged.

Give the trees as A B B A so that drift of the host shows.  Every
measurement is one JSON line on standard output, tagged with its tree and
its place in the order; the card's name and power limit come first.
"""

from __future__ import annotations

import glob
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.abspath(__file__))


def _child(phase: str, tree: str, ckpt_json: str | None) -> None:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    import bergen_tpu_torch

    if os.path.dirname(os.path.dirname(bergen_tpu_torch.__file__)) != tree:
        cs.fail(f"imported {bergen_tpu_torch.__file__}, not {tree}'s")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if phase == "decode_attention":
        cs.check_decode_attention({}, dev)
        return
    if phase == "kernels":
        cs.check_encoder_layer({}, dev)
        cs.check_bin_topk({}, dev)
        return
    if phase == "w8a8":
        cs.check_encoder_layer_q({}, dev)
        return
    cs.COUNT_KERNELS = tree == REPO
    if phase == "attention":
        cs.check_flash_attention({}, dev)
        cs.check_encoder_attention({}, dev)
        return
    if phase == "score_paged":
        cs.check_pallas_score({}, dev)
        cs.check_paged_attention({}, dev)
        return
    if phase == "band_int8":
        cs.check_flash_attention_band({}, dev)
        cs.check_bin_topk_int8({}, dev)
        return
    with open(ckpt_json) as f:
        ckpt = json.load(f)
    work = tempfile.mkdtemp(prefix="ab_chip_")
    try:
        if phase == "serve_chunked":
            from bergen_tpu_torch.ops import flash_attention as fa

            cs.run_ut1_serve_mistral(ckpt, os.path.join(
                work, "ut1_serve_mistral"))
            torch.cuda.empty_cache()
            fa.flash_attention_band.launches = 0
            out = cs.run_ut1_serve_chunked_mistral(
                ckpt, os.path.join(work, "ut1_serve_chunked_mistral"))
            cs.emit({"phase": "ut1_serve_chunked_mistral",
                     "band_launches": fa.flash_attention_band.launches,
                     **out})
            return
        if phase == "serve_paged":
            from bergen_tpu_torch.ops import paged_attention as pa

            for kv in ("paged", "uniform"):
                pa.paged_partial.launches = 0
                out = cs.run_ut1_serve_mistral(ckpt, os.path.join(work, kv),
                                               kv)
                steps = out["decode_steps"]
                cs.emit({"phase": f"ut1_serve_mistral_{kv}",
                         "decode_steps": steps,
                         "paged_launches": pa.paged_partial.launches,
                         "launches_per_step":
                             pa.paged_partial.launches / steps,
                         "responses_sha256": out["responses_sha256"],
                         "responses": [r["response"] for r in cs._json(
                             out["exp"], "eval_dev_out.json")],
                         "wall_s": out["wall_s"], "stage_s": out["stage_s"]})
                torch.cuda.empty_cache()
            return
        for path, run in (("ut1_eval", cs.run_main_path),
                          ("ut1_int4_llama2", cs.run_ut1_int4_llama2)):
            out = run(ckpt, os.path.join(work, path))
            cs.emit({"phase": path, "wall_s": out["wall_s"],
                     "stage_s": out["stage_s"]})
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)


def compare_answers(rows: list[dict]) -> list[dict]:
    """serve_paged's answers compared: each KV mode across the first two
    trees, and paged against uniform within each tree (answers that
    differ, and the first differing character of each)."""
    by = {(r["tree"], r["phase"]): r["responses"] for r in rows
          if "responses" in r}
    trees = list(dict.fromkeys(t for t, _ in by))
    modes = ("ut1_serve_mistral_paged", "ut1_serve_mistral_uniform")
    pairs = [tuple((t, m) for t in trees[:2]) for m in modes] + [
        tuple((t, m) for m in modes) for t in trees]
    out = []
    for a, b in pairs:
        if a not in by or b not in by:
            continue
        first = [next((j for j, (u, v) in enumerate(zip(x, y)) if u != v),
                      min(len(x), len(y)))
                 for x, y in zip(by[a], by[b]) if x != y]
        out.append({"phase": "serve_compare", "a": list(a), "b": list(b),
                    "answers": len(by[a]), "differ": len(first),
                    "first_diff_char": [min(first), max(first)]
                    if first else None})
    return out


def _sass_functions(cubin: str) -> list[str]:
    """The cubin's functions as instruction texts, sorted (names,
    addresses and encodings left out)."""
    from bergen_tpu_torch.ops import _build

    objdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([objdump, "-sass", cubin], capture_output=True,
                          text=True, check=True).stdout
    funcs: list[list[str]] = []
    for line in text.splitlines():
        if re.match(r"\s*Function : ", line):
            funcs.append([])
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if m and funcs:
            funcs[-1].append(" ".join(m.group(1).split()))
    return sorted("\n".join(f) for f in funcs)


def sass(trees: list[str]) -> None:
    import chip_smoke as cs
    from bergen_tpu_torch.ops import _build

    work = tempfile.mkdtemp(prefix="ab_sass_")
    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    names = [os.path.basename(p)
             for p in sorted(glob.glob(os.path.join(_build.CSRC, "*.cu")))]
    try:
        procs = []  # every build at once, as the kernels' own build does
        for name in names:
            for i, tree in enumerate(trees):
                csrc = os.path.join(os.path.abspath(tree), "bergen_tpu_torch",
                                    "csrc")
                procs.append(subprocess.Popen(
                    [_build._nvcc(), *flags, "-cubin", "-I", csrc, "-o",
                     os.path.join(work, f"{i}.{name}.cubin"),
                     os.path.join(csrc, name)]))
        if any([p.wait() for p in procs]):
            cs.fail("sass: nvcc failed")
        for name in names:
            funcs = [_sass_functions(os.path.join(work, f"{i}.{name}.cubin"))
                     for i in range(2)]
            cs.emit({"phase": "sass", "source": name, "trees": trees,
                     "functions": [len(f) for f in funcs],
                     "instructions": [sum(x.count("\n") + 1 for x in f)
                                      for f in funcs],
                     "identical": funcs[0] == funcs[1],
                     # functions of the first tree found unchanged in the
                     # second (a source whose other kernels changed)
                     "unchanged": sum(1 for f in funcs[0] if f in funcs[1])})
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main() -> None:
    if sys.argv[1:2] == ["--child"]:
        _child(*sys.argv[2:5])
        return
    if sys.argv[1:2] == ["sass"] and len(sys.argv) == 4:
        sys.path.insert(0, REPO)
        sass(sys.argv[2:])
        return
    if len(sys.argv) < 3 or sys.argv[1] not in (
            "decode_attention", "kernels", "attention", "w8a8",
            "score_paged", "paths", "serve_paged", "band_int8",
            "serve_chunked"):
        sys.exit(__doc__)
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this script needs a GPU")
    phase, trees = sys.argv[1], sys.argv[2:]
    print(cs.card_line(), flush=True)
    ckpt_json = root = None
    if phase in ("paths", "serve_paged", "serve_chunked"):
        sys.path.insert(0, REPO)
        dev = torch.device("cuda", 0)
        root = os.path.join(REPO, "bergen_tpu_torch", "_build",
                            "ab_checkpoints")
        ckpt = cs.write_checkpoints(root, dev)
        if phase == "paths":
            ckpt["llama2_7b"] = cs.write_llama2_7b(root, dev)
        else:
            ckpt["mistral_7b"] = cs.write_mistral_7b(root, dev)
        torch.cuda.empty_cache()
        ckpt_json = os.path.join(root, "ckpt.json")
        with open(ckpt_json, "w") as f:
            json.dump(ckpt, f)
    rows = []
    try:
        for i, tree in enumerate(trees):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", phase,
                 tree, ckpt_json or ""],
                cwd=REPO, capture_output=True, text=True)
            sys.stderr.write(proc.stderr[-4000:])
            for line in proc.stdout.splitlines():
                if line.startswith("{"):
                    rows.append({"tree": tree, "order": i,
                                 **json.loads(line)})
                    cs.emit(rows[-1])
            if proc.returncode:
                cs.fail(f"{phase} on {tree} exited with {proc.returncode}")
        if phase == "serve_paged":
            for row in compare_answers(rows):
                cs.emit(row)
    finally:
        if root is not None:
            shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
