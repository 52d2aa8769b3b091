"""Provence training (the PyTorch port's counterpart of
``bergen_tpu/train/provence.py`` and ``scripts/provence/train_provence.py``):
a DeBERTa cross-encoder gains a per-token two-class compression head
trained on silver sentence labels beside its ranking head, distilled from
a teacher's scores; the loss is the compression CE over every position
(pads carry label 0) plus ``loss_weight`` times the ranking MSE.

The forward is DeBERTa's unfused route (``deberta.encode(fused=False)``,
JAX's ``fused=False``): it is differentiated, and the fused layer kernel has
no backward.  Parameters and moments are f32 on every device, as JAX keeps
them.  The ranking head (``pooler``, ``classifier``) is a cross-encoder
checkpoint's own where it has one; missing heads, and always the
compression head (JAX's sequence-classification loader drops a
checkpoint's ``token_classifier``), are drawn N(0, 0.02) with zero biases
from a seeded ``torch.Generator``.

Run it as ``python -m bergen_tpu_torch.train.provence --silver_dir DIR
--outdir DIR [--teacher_trec RUN] [--model CKPT] [--device cpu]``, with the
root script's flags; it writes ``train_log.csv`` and
``provence_params.npz`` under ``--outdir``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

import numpy as np
import torch

from bergen_tpu_torch import device as _device
from bergen_tpu_torch.models import convert, deberta
from bergen_tpu_torch.models.core import ACT_FNS, dense
from bergen_tpu_torch.models.tokenizer import Tokenizer
from bergen_tpu_torch.train.optim import AdamW, warmup_cosine_decay_schedule


def init_heads(generator: torch.Generator, cfg, params, device=None):
    """Add the ranking ('pooler' + 'classifier') and compression
    ('token_classifier') heads a tree lacks, kernels N(0, 0.02) drawn in
    that order from ``generator`` on the host, biases zero."""
    H = cfg.hidden_size

    def lin(d_in, d_out):
        k = torch.randn(d_in, d_out, generator=generator) * 0.02
        return {"kernel": k.to(device), "bias": torch.zeros(d_out,
                                                            device=device)}

    params = dict(params)
    for name, d_out in (("pooler", H), ("classifier", 2),
                        ("token_classifier", 2)):
        if name not in params:
            params[name] = lin(H, d_out)
    return params


def forward(params, cfg, input_ids, attention_mask):
    """-> (ranking scores [B], token logits [B, S, 2]), both f32."""
    hidden = deberta.encode(params, cfg, input_ids, attention_mask,
                            fused=False)
    pooled = ACT_FNS[cfg.pooler_hidden_act](dense(params["pooler"],
                                                  hidden[:, 0]))
    ranking = dense(params["classifier"], pooled)[:, 0]
    token_logits = dense(params["token_classifier"], hidden).float()
    return ranking.float(), token_logits


def joint_loss(params, cfg, batch, loss_weight: float = 1.0):
    """(compression CE over all positions + loss_weight * ranking MSE,
    (compression, ranking))."""
    ranking, token_logits = forward(params, cfg, batch["input_ids"],
                                    batch["attention_mask"])
    logp = torch.log_softmax(token_logits, dim=-1)
    comp = -torch.gather(logp, -1, batch["labels"][..., None]).mean()
    rank = torch.square(ranking - batch["ranking_labels"]).mean()
    return comp + loss_weight * rank, (comp, rank)


class ProvenceTrainer:
    """rows: {query, context: [sentence, ...], selected_sents: [index, ...],
    ranking_label} (the silver-labelling output)."""

    def __init__(self, model_name: str, train_rows: List[dict],
                 eval_rows: List[dict], output_dir: str, max_len: int = 512,
                 batch_size: int = 16, lr: float = 1e-5, epochs: int = 1,
                 loss_weight: float = 1.0, seed: int = 0,
                 device: str | torch.device | None = None):
        self.device = _device.resolve(device)
        self.tokenizer = Tokenizer.from_pretrained(model_name)
        hf_cfg, sd = convert.load_checkpoint(model_name)
        self.cfg = deberta.DebertaConfig.from_hf(hf_cfg)
        params = convert.deberta_from_hf(sd, self.cfg.num_layers)
        del sd
        params.pop("token_head", None)
        params = convert.to_device(params, torch.float32, self.device)
        self.params = init_heads(torch.Generator().manual_seed(seed),
                                 self.cfg, params, self.device)
        self.train_rows, self.eval_rows = train_rows, eval_rows
        self.max_len = max_len
        self.batch_size = batch_size
        self.epochs = epochs
        self.loss_weight = loss_weight
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self.rng = np.random.default_rng(seed)

        n_steps = max(1, len(train_rows) // batch_size * epochs)
        warmup = max(n_steps // 20, 1)
        sched = warmup_cosine_decay_schedule(0.0, lr, warmup,
                                             max(n_steps, warmup + 1))
        self.leaves = list(convert.flatten_paths(self.params).values())
        self.optimizer = AdamW(self.leaves, sched, weight_decay=0.01)

    # ------------------------------------------------------------------ #

    def _collate(self, rows: List[dict]) -> Dict[str, torch.Tensor]:
        """[CLS] query [SEP] sent0 sent1 ... [SEP]; token labels 1 on the
        selected sentences' tokens, 0 elsewhere (specials, pads)."""
        tok = self.tokenizer
        cls_id, sep_id = tok.cls_token_id, tok.sep_token_id
        pad_id = tok.pad_token_id or 0
        B = len(rows)
        ii = np.full((B, self.max_len), pad_id, np.int64)
        am = np.zeros((B, self.max_len), np.int64)
        lab = np.zeros((B, self.max_len), np.int64)
        ranks = np.zeros((B,), np.float32)
        for r, row in enumerate(rows):
            q_ids = tok(row["query"], add_special_tokens=False)["input_ids"]
            ids = [cls_id] + q_ids + [sep_id]
            labels = [0] * len(ids)
            selected = set(row["selected_sents"])
            for si, sent in enumerate(row["context"]):
                s_ids = tok(" " + sent if si else sent,
                            add_special_tokens=False)["input_ids"]
                ids += s_ids
                labels += [int(si in selected)] * len(s_ids)
            ids, labels = ids + [sep_id], labels + [0]
            ids, labels = ids[: self.max_len], labels[: self.max_len]
            ii[r, : len(ids)] = ids
            am[r, : len(ids)] = 1
            lab[r, : len(labels)] = labels
            ranks[r] = float(row.get("ranking_label", 0.0))
        dev = self.device
        return {"input_ids": torch.from_numpy(ii).to(dev),
                "attention_mask": torch.from_numpy(am).to(dev),
                "labels": torch.from_numpy(lab).to(dev),
                "ranking_labels": torch.from_numpy(ranks).to(dev)}

    def batches(self, rows, shuffle):
        order = np.arange(len(rows))
        if shuffle:
            self.rng.shuffle(order)
        for s in range(0, len(order) - len(order) % self.batch_size
                       or len(order), self.batch_size):
            idx = order[s: s + self.batch_size]
            if len(idx):
                yield self._collate([rows[i] for i in idx])

    def loss_and_grads(self, batch):
        """((loss, compression, ranking), gradients of every leaf)."""
        for t in self.leaves:
            t.requires_grad_(True)
        try:
            with torch.enable_grad():
                loss, (comp, rank) = joint_loss(self.params, self.cfg, batch,
                                                self.loss_weight)
                grads = torch.autograd.grad(loss, self.leaves)
        finally:
            for t in self.leaves:
                t.requires_grad_(False)
        return (loss.detach(), comp.detach(), rank.detach()), grads

    def train_step(self, batch):
        losses, grads = self.loss_and_grads(batch)
        self.optimizer.step(grads)
        return tuple(float(v) for v in losses)

    @torch.no_grad()
    def evaluate(self) -> Dict[str, float]:
        preds, labels, losses = [], [], []
        for batch in self.batches(self.eval_rows, False):
            _, token_logits = forward(self.params, self.cfg,
                                      batch["input_ids"],
                                      batch["attention_mask"])
            loss, _ = joint_loss(self.params, self.cfg, batch,
                                 self.loss_weight)
            preds.append(token_logits.argmax(-1).cpu().numpy().ravel())
            labels.append(batch["labels"].cpu().numpy().ravel())
            losses.append(float(loss))
        if not preds:
            return {}
        p = np.concatenate(preds)
        lb = np.concatenate(labels)
        tp = int(np.sum((p == 1) & (lb == 1)))
        fp = int(np.sum((p == 1) & (lb == 0)))
        fn = int(np.sum((p == 0) & (lb == 1)))
        prec = tp / (tp + fp) if tp + fp else 0.0
        rec = tp / (tp + fn) if tp + fn else 0.0
        return {
            "loss": float(np.mean(losses)),
            "acc": float(np.mean(p == lb)),
            "precision": prec,
            "recall": rec,
            "f1": 2 * prec * rec / (prec + rec) if prec + rec else 0.0,
        }

    def train(self) -> Dict:
        log_path = os.path.join(self.output_dir, "train_log.csv")
        history, step = [], 0
        with open(log_path, "w") as log:
            log.write("step,loss,compression_loss,ranking_loss\n")
            for _ in range(self.epochs):
                for batch in self.batches(self.train_rows, True):
                    loss, comp, rank = self.train_step(batch)
                    step += 1
                    log.write(f"{step},{loss:.4f},{comp:.4f},{rank:.4f}\n")
                    history.append(loss)
        metrics = self.evaluate()
        flat = {p: t.detach().cpu().numpy()
                for p, t in convert.flatten_paths(self.params).items()}
        np.savez(os.path.join(self.output_dir, "provence_params.npz"), **flat)
        return {"steps": step, "train_loss": history, "eval": metrics}


def load_rows(silver_dir: str, teacher_trec: str | None):
    """The silver-label rows, each with its teacher score (0 without)."""
    from bergen_tpu_torch.utils import load_trec

    teacher = {}
    if teacher_trec:
        q_ids, d_ids, scores = load_trec(teacher_trec)
        for q, docs, ss in zip(q_ids, d_ids, scores):
            for d, s in zip(docs, ss):
                teacher[f"{q}_{d}"] = float(s)
    rows = []
    for path in sorted(glob.glob(os.path.join(silver_dir, "*.json"))):
        with open(path) as f:
            item = json.load(f)
        key = os.path.splitext(os.path.basename(path))[0]
        rows.append({
            "query": item["query"],
            "context": item["context"],
            "selected_sents": item["selected_sents"],
            "ranking_label": teacher.get(key, 0.0),
        })
    return rows


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Train a Provence context pruner and reranker")
    parser.add_argument("--silver_dir", required=True,
                        help="folder of per-example silver-label json files")
    parser.add_argument("--teacher_trec", default=None,
                        help="reranking TREC run with teacher scores")
    parser.add_argument("--model",
                        default="naver/trecdl22-crossencoder-debertav3")
    parser.add_argument("--outdir", required=True)
    parser.add_argument("--max_len", type=int, default=512)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--lr", type=float, default=1e-5)
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--loss_weight", type=float, default=1.0)
    parser.add_argument("--eval_fraction", type=float, default=0.05)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    rows = load_rows(args.silver_dir, args.teacher_trec)
    if not rows:
        raise SystemExit(f"no silver-label json files found in {args.silver_dir}")
    n_eval = max(1, int(len(rows) * args.eval_fraction))
    train_rows, eval_rows = rows[n_eval:], rows[:n_eval]
    print(f"{len(train_rows)} train / {len(eval_rows)} eval examples")
    trainer = ProvenceTrainer(
        args.model, train_rows, eval_rows, args.outdir,
        max_len=args.max_len, batch_size=args.batch_size, lr=args.lr,
        epochs=args.epochs, loss_weight=args.loss_weight, device=args.device,
    )
    result = trainer.train()
    print(json.dumps({"steps": result["steps"], "eval": result["eval"]}))


if __name__ == "__main__":
    main()
