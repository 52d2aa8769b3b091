"""Same-host A/B of the port's source trees on one GPU.

    python3 ab_chip.py decode_attention TREE [TREE ...]
    python3 ab_chip.py kernels TREE [TREE ...]
    python3 ab_chip.py attention TREE [TREE ...]
    python3 ab_chip.py paths TREE [TREE ...]
    python3 ab_chip.py w8a8 TREE [TREE ...]

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
* ``paths``: the ut1_eval and ut1_int4_llama2 runs of ``python -m
  bergen_tpu_torch`` (stage times), on checkpoints that this process
  writes once, before the first tree, and deletes at the end.

Give the trees as A B B A so that drift of the host shows.  Every
measurement is one JSON line on standard output, tagged with its tree and
its place in the order; the card's name and power limit come first.
"""

from __future__ import annotations

import json
import os
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
    if phase == "attention":
        cs.COUNT_KERNELS = tree == REPO
        cs.check_flash_attention({}, dev)
        cs.check_encoder_attention({}, dev)
        return
    with open(ckpt_json) as f:
        ckpt = json.load(f)
    work = tempfile.mkdtemp(prefix="ab_chip_")
    try:
        for path, run in (("ut1_eval", cs.run_main_path),
                          ("ut1_int4_llama2", cs.run_ut1_int4_llama2)):
            out = run(ckpt, os.path.join(work, path))
            cs.emit({"phase": path, "wall_s": out["wall_s"],
                     "stage_s": out["stage_s"]})
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main() -> None:
    if sys.argv[1:2] == ["--child"]:
        _child(*sys.argv[2:5])
        return
    if len(sys.argv) < 3 or sys.argv[1] not in ("decode_attention",
                                                "kernels", "attention",
                                                "w8a8", "paths"):
        sys.exit(__doc__)
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this script needs a GPU")
    phase, trees = sys.argv[1], sys.argv[2:]
    print(cs.card_line(), flush=True)
    ckpt_json = root = None
    if phase == "paths":
        sys.path.insert(0, REPO)
        dev = torch.device("cuda", 0)
        root = os.path.join(REPO, "bergen_tpu_torch", "_build",
                            "ab_checkpoints")
        ckpt = cs.write_checkpoints(root, dev)
        ckpt["llama2_7b"] = cs.write_llama2_7b(root, dev)
        torch.cuda.empty_cache()
        ckpt_json = os.path.join(root, "ckpt.json")
        with open(ckpt_json, "w") as f:
            json.dump(ckpt, f)
    try:
        for i, tree in enumerate(trees):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", phase,
                 tree, ckpt_json or ""],
                cwd=REPO, capture_output=True, text=True)
            sys.stderr.write(proc.stderr[-4000:])
            for line in proc.stdout.splitlines():
                if line.startswith("{"):
                    cs.emit({"tree": tree, "order": i, **json.loads(line)})
            if proc.returncode:
                cs.fail(f"{phase} on {tree} exited with {proc.returncode}")
    finally:
        if root is not None:
            shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
