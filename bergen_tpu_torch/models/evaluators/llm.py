"""LLM-judge evaluation (the PyTorch port's counterpart of
``bergen_tpu/models/evaluators/llm.py``; reference
``models/evaluators/llm.py``), on the port's ``LLM``.

Prompted yes/no judging of generated answers with two scoring modes:

* **logits**: the probability mass over the option tokens at the first generated
  position is interpolated with the option values — ``sum p(label)*value``
  (reference :165-180): one prefill through ``LLM.first_token_logits``, no
  decoding.
* **text**: greedy decode (``LLM.generate``) + substring matching of the
  options.

Pairwise protocol: answer order randomly switched per sample to deter
positional bias, scores unswitched afterwards (reference :77-93, 182-196).
The prompt templates are the evaluator config's f-strings, evaluated with no
builtins, as in the JAX package.  The judge runs on ``device`` (default
``cuda``).
"""

from __future__ import annotations

import os
import random

import numpy as np

from bergen_tpu_torch import confy
from bergen_tpu_torch.models.evaluators.utils import (
    get_mean_without_unknown,
    get_pairwise_scores_without_unknown,
    process_llm_outputs_assess_scores,
    unswitch_switched_scores,
)
from bergen_tpu_torch.parallel import mesh


def _load_eval_config(config: str):
    for base in ("config/evaluator", os.path.join(os.path.dirname(__file__), "..", "..", "..", "config", "evaluator")):
        path = os.path.join(base, f"{config}.yaml")
        if os.path.exists(path):
            return confy.load_yaml(path)
    raise FileNotFoundError(f"evaluator config '{config}' not found")


class LLMeval:
    def __init__(self, model_config: dict, batch_size: int | None = None,
                 config: str = "default_qa", device=None):
        eval_config = _load_eval_config(config)
        model_config["init_args"]["max_new_tokens"] = eval_config["max_new_tokens"]
        self.llm = confy.instantiate(
            model_config["init_args"], prompt=eval_config["prompt"],
            device=device,
        )
        self.use_logits = bool(eval_config.get("use_logits", False)) and hasattr(
            self.llm, "first_token_logits"
        )

        self.options = dict(eval_config["output_options"])
        self.rubrik_section = ", ".join(self.options)
        self.options_pairwise = {
            str(k): v for k, v in eval_config["output_options_pairwise"].items()
        }
        self.prompt = eval_config["prompt"]
        self.prompt_pairwise = eval_config["prompt_pairwise"]
        self.system_prompt = eval(
            self.prompt["system"], {"__builtins__": {}}, {"self": self}
        ).replace(":\\ ", ": ")
        self.system_prompt_pairwise = eval(
            self.prompt_pairwise["system"], {"__builtins__": {}}, {"self": self}
        ).replace(":\\ ", ": ")
        self.batch_size = batch_size or self.llm.batch_size
        self.llm.max_new_tokens = eval_config["max_new_tokens"]

        tok = self.llm.tokenizer
        self.output_ids = [
            tok.encode(opt, add_special_tokens=False) for opt in sorted(self.options)
        ]
        self.output_values = np.array(
            [self.options[o] for o in sorted(self.options)], dtype=np.float32
        )

    # ------------------------------------------------------------------ #

    def _user_eval(self, template, **kw):
        kw["self"] = self
        return eval(template, {"__builtins__": {}}, kw).replace(":\\ ", ": ")

    def create_instruction(self, answer, question, prediction) -> str:
        tok = self.llm.tokenizer
        if tok.chat_template is not None and "system" in tok.chat_template:
            messages = [
                {"role": "system", "content": self.system_prompt},
                {"role": "user", "content": self._user_eval(
                    self.prompt["user"], question=question, answer=answer,
                    prediction=prediction)},
            ]
        else:
            messages = [
                {"role": "user", "content": self._user_eval(
                    self.prompt["user_without_system"], question=question,
                    answer=answer, prediction=prediction)},
            ]
        return tok.apply_chat_template(
            messages, add_generation_prompt=True, tokenize=False
        )

    def create_pairwise_instruction(self, question, answer, prediction_1,
                                    prediction_2):
        switch = random.choice([True, False])
        if switch:
            prediction_1, prediction_2 = prediction_2, prediction_1
        tok = self.llm.tokenizer
        if tok.chat_template is None:
            raise ValueError("pairwise judging needs a chat template")
        messages = [
            {"role": "system", "content": self.system_prompt_pairwise},
            {"role": "user", "content": self._user_eval(
                self.prompt_pairwise["user"], question=question, answer=answer,
                prediction_1=prediction_1, prediction_2=prediction_2)},
        ]
        return (
            tok.apply_chat_template(messages, add_generation_prompt=True,
                                    tokenize=False),
            switch,
        )

    def create_inputs(self, predictions, references, questions,
                      opponent_predictions=None):
        if not len(predictions) == len(references) == len(questions):
            raise ValueError("predictions, references and questions differ in "
                             "length")
        pairwise = opponent_predictions is not None
        inputs = []
        for i in range(len(predictions)):
            if pairwise:
                instr, switch = self.create_pairwise_instruction(
                    question=questions[i], answer=references[i],
                    prediction_1=predictions[i],
                    prediction_2=opponent_predictions[i],
                )
                inputs.append({"instr": instr, "switch": switch})
            else:
                inputs.append({
                    "instr": self.create_instruction(
                        question=questions[i], answer=references[i],
                        prediction=predictions[i])
                })
        return inputs

    # ------------------------------------------------------------------ #

    def __call__(self, predictions, references, questions,
                 opponent_predictions=None):
        pairwise = opponent_predictions is not None
        options = self.options_pairwise if pairwise else self.options
        inputs = self.create_inputs(
            predictions=predictions, references=references, questions=questions,
            opponent_predictions=opponent_predictions,
        )
        # a tensor-parallel judge: every rank prompts as rank 0 drew the
        # pairwise switches
        inputs = mesh.broadcast_object(inputs)
        scores, weirds = [], []
        for s in range(0, len(inputs), self.batch_size):
            batch = inputs[s : s + self.batch_size]
            instrs = [b["instr"] for b in batch]
            if self.use_logits and not pairwise:
                logits = self.llm.first_token_logits(instrs)  # [B, V]
                first_ids = [ids[0] for ids in self.output_ids]
                opt_logits = logits[:, first_ids]
                p = np.exp(opt_logits - opt_logits.max(axis=1, keepdims=True))
                p = p / p.sum(axis=1, keepdims=True)
                scores.extend((p @ self.output_values).tolist())
            else:
                decoded = self.llm.generate(instrs)
                b_scores, b_weird = process_llm_outputs_assess_scores(
                    decoded, options
                )
                if pairwise:
                    switches = [b["switch"] for b in batch]
                    b_scores = unswitch_switched_scores(b_scores, switches)
                weirds.extend(b_weird)
                scores.extend(b_scores)

        if pairwise:
            return get_pairwise_scores_without_unknown(scores), scores
        return get_mean_without_unknown(scores), scores


# the reference's separate vLLM judge (models/evaluators/vllm.py); here both
# ride the port's LLM
VLLMeval = LLMeval
