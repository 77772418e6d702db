"""VQA answer table and the answer head's row surgery (counterpart of
``visualbert_tpu/data/answer_table.py``; reference
``unsupervised_visualbert/src/pretrain/qa_answer_table.py``).

Pretraining's answer head covers a ~9500-answer union table; a fine-tuning
task has its own vocabulary. Loading a pretrained head re-indexes the last
layer's rows by answer string (qa_answer_table.py:88-161): the rows of the
answers in both tables are copied, the others zeroed.
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Sequence

import numpy as np

# the reference's ``AnswerTable.convert_ans`` (qa_answer_table.py:9-63):
# lower case, no trailing period or leading article, digits, grey -> gray
_ANS_CONVERT = {
    "a man": "man", "the man": "man",
    "a woman": "woman", "the woman": "woman",
    "one": "1", "two": "2", "three": "3", "four": "4", "five": "5",
    "six": "6", "seven": "7", "eight": "8", "nine": "9", "ten": "10",
    "grey": "gray",
}


def normalize_answer(ans: str) -> str:
    if not ans:
        return ""
    ans = ans.lower()
    if ans.endswith("."):
        ans = ans[:-1].strip()
    for art in ("a ", "an ", "the "):
        if ans.startswith(art):
            ans = ans[len(art):].strip()
            break
    return _ANS_CONVERT.get(ans, ans)


class AnswerTable:
    def __init__(self, answers: Sequence[str]):
        self.answers = [normalize_answer(a) for a in answers]
        self.ans2id = {a: i for i, a in enumerate(self.answers)}

    @classmethod
    def from_json(cls, path: str) -> "AnswerTable":
        with open(path) as f:
            return cls(json.load(f))

    def __len__(self):
        return len(self.answers)

    def ans_to_id(self, ans: str) -> Optional[int]:
        return self.ans2id.get(normalize_answer(ans))

    def id_to_ans(self, i: int) -> str:
        return self.answers[i]

    def used(self, ans: str) -> bool:
        return normalize_answer(ans) in self.ans2id


def remap_answer_head(kernel: np.ndarray, bias: np.ndarray, src_table: AnswerTable, dst_table: AnswerTable,
                      dst_kernel: np.ndarray, dst_bias: np.ndarray, zero_unmatched: bool = True) -> Dict:
    """The last layer's columns of ``kernel`` [hidden, n_src] and ``bias``
    [n_src] moved by answer string into fresh ``dst_kernel`` [hidden, n_dst]
    and ``dst_bias``; unmatched answers zeroed (qa_answer_table.py:139-143)
    unless ``zero_unmatched`` is False. A port ``nn.Linear`` weight is the
    transpose of ``kernel``. Returns {"kernel", "bias", "n_copied"}."""
    out_k = np.array(dst_kernel)
    out_b = np.array(dst_bias)
    n_copied = 0
    for dst_i, ans in enumerate(dst_table.answers):
        src_i = src_table.ans_to_id(ans)
        if src_i is not None:
            out_k[:, dst_i] = kernel[:, src_i]
            out_b[dst_i] = bias[src_i]
            n_copied += 1
        elif zero_unmatched:
            out_k[:, dst_i] = 0.0
            out_b[dst_i] = 0.0
    return {"kernel": out_k, "bias": out_b, "n_copied": n_copied}
