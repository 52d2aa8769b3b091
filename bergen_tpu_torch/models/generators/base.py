"""Generator ABC: prompt compilation + batched eval loop (the PyTorch
port's copy of ``bergen_tpu/models/generators/base.py``).

Behavioural port of reference ``models/generators/generator.py``: the
``Document {i}: {doc}`` prompt assembly with ``max_doc_len`` word crop
(:166-191), chat-template compilation with training label-start tracking
(:77-133), middle truncation preserving head+tail (:135-163), and the
length-sorted eval loop (:40-64).  The engine under ``generate()`` is the
port's llama forward (see llm.py).
"""

from __future__ import annotations

import random
import warnings
from abc import ABC, abstractmethod
from typing import List, Tuple

# the config prompt templates contain literal '\ ' sequences (see
# config/prompt/basic.yaml, same as the reference's) which eval() warns about
warnings.filterwarnings("ignore", category=SyntaxWarning)


class Generator(ABC):
    def __init__(
        self,
        model_name: str | None = None,
        batch_size: int = 1,
        max_new_tokens: int = 1,
        max_doc_len: int = 10**10,
        max_length: int | None = None,
        use_middle_truncation: bool = False,
    ):
        self.model_name = model_name
        self.batch_size = batch_size
        self.max_new_tokens = max_new_tokens
        self.max_doc_len = max_doc_len
        self.max_length = max_length
        self.use_middle_truncation = use_middle_truncation
        self.tokenizer = None
        self.prompt = None

    @abstractmethod
    def generate(self, instr_tokenized) -> List[str]:
        ...

    def get_clean_model_name(self) -> str:
        return (self.model_name or "generator").replace("/", "_")

    # ------------------------------------------------------------------ #
    # prompt compilation
    # ------------------------------------------------------------------ #

    def get_response(self) -> str:
        """Generation incitation used when no chat template exists; also marks
        the label start for training masking."""
        return "\nResponse:\n"

    def compile_prompt(
        self,
        system_prompt: str,
        user_prompt: str,
        question: str,
        docs: str | None = None,
        label: str | None = None,
    ) -> Tuple[str, int | None]:
        """Build the final prompt string. ``user_prompt`` is a config f-string
        template (e.g. ``f"Background:\\n{docs}\\n\\nQuestion:\\ {question}"``,
        config/prompt/basic.yaml) evaluated with ``question``/``docs`` bound.
        If ``label`` is given (training) the answer is appended and the token
        index where the label starts is returned for loss masking."""
        add_generation_prompt = label is None
        user_text = eval(user_prompt, {"__builtins__": {}},
                         {"question": question, "docs": docs}).replace(":\\ ", ": ")
        label_start_index = None

        if self.tokenizer.chat_template is None:
            prompt = f"{system_prompt}\n{user_text}" + self.get_response()
            if label is not None:
                label_start_index = len(
                    self.tokenizer(prompt, add_special_tokens=False)["input_ids"]
                )
                prompt += label + self.tokenizer.eos_token
            return prompt, label_start_index

        messages = [
            {"role": "system", "content": system_prompt},
            {"role": "user", "content": user_text},
        ]
        try:
            prompt, label_start_index = self._apply_template(
                messages, label, add_generation_prompt
            )
        except Exception as e:  # models without a system role (gemma et al.)
            if "System role not supported" in str(e):
                messages = [
                    {"role": "user",
                     "content": messages[0]["content"] + "\n" + messages[1]["content"]}
                ]
                prompt, label_start_index = self._apply_template(
                    messages, label, add_generation_prompt
                )
            else:
                raise
        if label is not None:
            assert label_start_index is not None
            if not prompt.endswith(self.tokenizer.eos_token):
                prompt += self.tokenizer.eos_token
        return prompt, label_start_index

    def _apply_template(self, messages, label, add_generation_prompt):
        label_start_index = None
        if label is not None:
            label_start_index = len(
                self.tokenizer.apply_chat_template(
                    messages, tokenize=True, add_generation_prompt=True,
                    add_special_tokens=False,
                )
            )
            messages = messages + [{"role": "assistant", "content": label}]
        prompt = self.tokenizer.apply_chat_template(
            messages, add_generation_prompt=add_generation_prompt, tokenize=False
        )
        return prompt, label_start_index

    def middle_truncation(self, docs: str | None) -> str | None:
        """Drop the middle of an over-long doc block, keep head+tail
        (reference generator.py:135-163)."""
        if docs is None or self.max_length is None or self.tokenizer is None:
            return docs
        ids = self.tokenizer(docs, truncation=False)["input_ids"]
        threshold = self.max_length - 128
        assert threshold >= 0, "max_length too small for middle truncation"
        if len(ids) > threshold:
            half = threshold // 2
            head = self.tokenizer.decode(ids[:half], skip_special_tokens=True)
            tail = self.tokenizer.decode(ids[-half:], skip_special_tokens=True)
            docs = head + tail
        return docs

    def format_instruction(self, sample: dict, eval: bool = True):
        """sample: {'query', optional 'doc' list, optional 'label'} → prompt.
        eval=False appends the (teacher-forcing) label."""
        question = sample["query"]
        label = None
        if not eval:
            label = (
                sample["label"]
                if isinstance(sample["label"], str)
                else random.choice(sample["label"])
            )
        if "doc" in sample and sample["doc"] is not None:
            docs = ""
            input_docs = [d for d in sample["doc"] if len(d.strip()) > 0]
            for i, doc in enumerate(input_docs):
                doc = " ".join(doc.split()[: self.max_doc_len])
                docs += f"Document {i + 1}: {doc}\n"
            if self.use_middle_truncation:
                docs = self.middle_truncation(docs)
            return self.compile_prompt(
                self.prompt.system, self.prompt.user, question, docs, label=label
            )
        return self.compile_prompt(
            self.prompt.system_without_docs, self.prompt.user_without_docs,
            question, label=label,
        )

    # ------------------------------------------------------------------ #
    # batched eval loop (reference generator.py:40-64)
    # ------------------------------------------------------------------ #

    def eval(self, dataset):
        """Length-sorted batched generation over an HF dataset with columns
        q_id/query/label/ranking_labels[/doc]. Returns parallel lists."""
        rows = []
        for item in dataset:
            prompt, _ = self.format_instruction(item, eval=True)
            n_tok = len(self.tokenizer(prompt, truncation=False)["input_ids"]) \
                if self.tokenizer else len(prompt.split())
            rows.append((n_tok, item, prompt))
        rows.sort(key=lambda r: r[0])

        query_ids, queries, instructions, responses, labels, ranking_labels = (
            [], [], [], [], [], []
        )
        for s in range(0, len(rows), self.batch_size):
            batch = rows[s : s + self.batch_size]
            prompts = [r[2] for r in batch]
            out = self.generate(prompts)
            for (_, item, prompt), resp in zip(batch, out):
                query_ids.append(item["q_id"])
                queries.append(item["query"])
                instructions.append(prompt)
                responses.append(resp)
                labels.append(item.get("label"))
                ranking_labels.append(item.get("ranking_labels"))
        return query_ids, queries, instructions, responses, labels, ranking_labels
