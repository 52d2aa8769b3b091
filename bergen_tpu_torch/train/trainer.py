"""SFT trainer (the PyTorch port's counterpart of
``bergen_tpu/train/trainer.py``, itself the reference's HF ``Trainer``
loop): LoRA-masked or full AdamW with a warmup-cosine schedule, periodic
eval, best-checkpoint keeping, and at the end the best adapters loaded and
merged into the generator.

Batches are right-padded to the generator's length bucket with the prompt
tokens masked out of the loss; the training order is JAX's: a numpy
``default_rng(seed)`` shuffle, then a length sort inside windows of eight
batches.  ``train=full`` (no ``lora`` key) trains every leaf.  Dtypes are
JAX's on its accelerator: the generator's weights in its compute dtype
(bf16 on the card, f32 on the CPU) with f32 norms, f32 adapters, and
moments in each trained leaf's dtype.  ``adapters_best.npz`` has JAX's key
names and shapes.  The loss's forward reaches no kernel (``step.py``); the
eval after training does.

A tensor-parallel generator (``LLM(tp=...)`` under ``torchrun``) trains
its rank's slice, as XLA partitions JAX's one jitted step over the
``model`` axis: the forward's collectives are differentiable
(``mesh.copy_in`` / ``reduce_out`` / ``gather_last``), so each rank's
gradients are those of the whole tree's step on its leaves, and AdamW
acts element-wise on them.  The replicated leaves (norms, embedding,
router, a row-parallel slice's bias, a slice's whole adapter factor) get
the same gradients on every rank and stay equal.  Every model row of a
world larger than tp trains the same batches (JAX's trainer takes its
inputs unsharded).  Rank 0 alone writes ``adapters_best.npz``, gathered
whole over its model row.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

from bergen_tpu_torch.models import convert
from bergen_tpu_torch.models.core import length_bucket
from bergen_tpu_torch.parallel import mesh as _mesh
from bergen_tpu_torch.train import lora as lora_lib
from bergen_tpu_torch.train.optim import AdamW, warmup_cosine_decay_schedule
from bergen_tpu_torch.train.step import causal_lm_loss


class SFTTrainer:
    def __init__(
        self,
        generator,                      # models.generators.llm.LLM
        train_rows: List[dict],         # formatted_instruction, label_start_index
        eval_rows: List[dict],
        training_config,
        output_dir: str,
        seed: int = 42,
    ):
        if getattr(generator, "quantization_route", None) is not None:
            raise NotImplementedError(
                f"training a {generator.quantization_route} generator: its "
                "projections are integer codes, which neither package "
                "differentiates; train the unquantized checkpoint")
        self.gen = generator
        self.cfg = generator.cfg
        self.device = generator.device
        self.train_rows = train_rows
        self.eval_rows = eval_rows
        self.tc = training_config
        self.output_dir = output_dir
        self.lead = _mesh.rank() == 0  # under torchrun rank 0 writes
        if self.lead:
            os.makedirs(output_dir, exist_ok=True)
        self.rng = np.random.default_rng(seed)

        t = training_config.get("trainer", {})
        self.batch_size = int(t.get("per_device_train_batch_size", 8))
        self.eval_batch_size = int(t.get("per_device_eval_batch_size", 8))
        self.epochs = int(t.get("num_train_epochs", 1))
        self.lr = float(t.get("learning_rate", 1e-4))
        self.weight_decay = float(t.get("weight_decay", 0.1))
        self.warmup_ratio = float(t.get("warmup_ratio", 0.05))

        params = self.gen.params
        if "lora" in training_config:
            lc = training_config["lora"]
            params = lora_lib.init_lora(
                params, rank=int(lc.get("r", 32)),
                alpha=float(lc.get("lora_alpha", 64)),
                generator=torch.Generator().manual_seed(seed))
            mask = lora_lib.lora_mask(params)
        else:
            mask = {p: True for p in convert.flatten_paths(params)}
        self.params = params
        # tensor leaves only (a slice's tp_shape is two ints)
        self.trainable = [(p, t) for p, t in
                          convert.flatten_paths(params).items()
                          if mask[p] and isinstance(t, torch.Tensor)]

        n_steps = max(1, (len(train_rows) // self.batch_size) * self.epochs)
        schedule = warmup_cosine_decay_schedule(
            0.0, self.lr, int(n_steps * self.warmup_ratio) + 1, n_steps)
        self.optimizer = AdamW([t for _, t in self.trainable], schedule,
                               self.weight_decay)
        self.n_steps = n_steps
        self.remat = bool(training_config.get("gradient_checkpointing", True))

    # ------------------------------------------------------------------ #

    def _collate(self, rows: List[dict], pad_to: int) -> Dict[str, torch.Tensor]:
        """Right-padded batch with prompt tokens masked out of the loss
        (JAX ``trainer.py:124-146``)."""
        tok = self.gen.tokenizer
        B = len(rows)
        max_len = min(pad_to, self.gen.max_length or pad_to)
        ii = np.full((B, max_len), tok.pad_token_id, dtype=np.int64)
        am = np.zeros((B, max_len), dtype=np.int64)
        lm = np.zeros((B, max_len), dtype=np.int64)
        for r, row in enumerate(rows):
            ids = tok(row["formatted_instruction"], add_special_tokens=False,
                      truncation=True, max_length=max_len)["input_ids"]
            ii[r, : len(ids)] = ids
            am[r, : len(ids)] = 1
            start = min(row["label_start_index"], len(ids))
            lm[r, start : len(ids)] = 1
        dev = self.device
        return {"input_ids": torch.from_numpy(ii).to(dev),
                "attention_mask": torch.from_numpy(am).to(dev),
                "loss_mask": torch.from_numpy(lm).to(dev)}

    def _token_len(self, row) -> int:
        if "_token_len" not in row:
            row["_token_len"] = len(
                self.gen.tokenizer(row["formatted_instruction"],
                                   add_special_tokens=False)["input_ids"])
        return row["_token_len"]

    def batches(self, rows, batch_size, shuffle):
        """JAX's order: shuffled, then length-sorted inside windows of
        eight batches."""
        order = np.arange(len(rows))
        if shuffle:
            self.rng.shuffle(order)
            window = batch_size * 8
            order = np.concatenate([
                sorted(order[s: s + window],
                       key=lambda i: self._token_len(rows[i]))
                for s in range(0, len(order), window)
            ]).astype(np.int64) if len(order) else order
        for s in range(0, len(order), batch_size):
            idx = order[s: s + batch_size]
            batch = [rows[i] for i in idx]
            longest = max(self._token_len(r) for r in batch)
            yield self._collate(batch, length_bucket(longest,
                                                     self.gen.buckets))

    def loss_and_grads(self, batch):
        """(loss, gradients of the trainable leaves in their order)."""
        leaves = [t for _, t in self.trainable]
        for t in leaves:
            t.requires_grad_(True)
        try:
            with torch.enable_grad():
                loss = causal_lm_loss(self.params, self.cfg,
                                      batch["input_ids"],
                                      batch["attention_mask"],
                                      batch["loss_mask"], self.remat)
                grads = torch.autograd.grad(loss, leaves)
        finally:
            for t in leaves:
                t.requires_grad_(False)
        return loss.detach(), grads

    def train_step(self, batch) -> float:
        loss, grads = self.loss_and_grads(batch)
        self.optimizer.step(grads)
        return float(loss)

    @torch.no_grad()
    def eval_loss(self, batch) -> float:
        # eval has no backward: remat would only add recompute
        return float(causal_lm_loss(self.params, self.cfg,
                                    batch["input_ids"],
                                    batch["attention_mask"],
                                    batch["loss_mask"], False))

    def evaluate(self) -> float:
        losses = [self.eval_loss(b) for b in
                  self.batches(self.eval_rows, self.eval_batch_size, False)]
        return float(np.mean(losses)) if losses else float("nan")

    def train(self) -> Dict[str, object]:
        num_saves = int(self.tc.get("num_saving_steps", 10))
        eval_every = max(self.n_steps // max(num_saves, 1), 1)
        best = {"loss": float("inf"), "adapters": None}
        history = []
        step = 0
        for _ in range(self.epochs):
            for batch in self.batches(self.train_rows, self.batch_size, True):
                loss = self.train_step(batch)
                step += 1
                if step % eval_every == 0 or step == self.n_steps:
                    eval_loss = self.evaluate()
                    history.append({"step": step, "train_loss": loss,
                                    "eval_loss": eval_loss})
                    if eval_loss < best["loss"]:
                        best["loss"] = eval_loss
                        best["adapters"] = lora_lib.extract_adapters(
                            self.params)
                        if self.lead:
                            np.savez(os.path.join(self.output_dir,
                                                  "adapters_best.npz"),
                                     **best["adapters"])
        # the best adapters (reference: load_best_model_at_end=True), then
        # merged into the generator for inference
        if best["adapters"]:
            self.params = lora_lib.load_adapters(self.params,
                                                 best["adapters"])
        self.gen.params = lora_lib.merge(self.params)
        return {"steps": step, "best_eval_loss": best["loss"],
                "history": history}
