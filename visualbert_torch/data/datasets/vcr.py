"""VCR dataset (``visualbert_tpu/data/datasets/vcr.py``, copied: importing
the JAX package pulls in JAX; reference ``visualbert/dataloaders/vcr.py`` +
``vcr_data_utils.py``). Its batches are byte-identical to the JAX
package's.

Each item: an image with detected objects, a question and 4 answer choices
(Q→A) or 4 rationale choices (QA→R). Text tokens may be *detection
references* — lists of object indices — which are rendered as gender-neutral
names (person) or the class name (other objects), with the mention's object
indices recorded for box↔token ``image_text_alignment``
(vcr_data_utils.py:14-62, vcr.py:325-403).

Annotations contract (one dict per item):
  {"image_id": str,
   "question": [token | [obj_idx, ...], ...],
   "choices": [[token | [obj_idx, ...], ...] x 4],
   "label": int,
   "objects": ["person", "car", ...]}      # class name per detected object
Image-side arrays come from the feature store under ``image_id``:
  {"image": [H, W, 3] uint8 or float, "boxes": [n, 4], "classes": [n] int,
   "segms": [n, 14, 14] float (optional), "height"/"width" (optional, the
   content extent inside a padded canvas)}
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from visualbert_torch.data.features import ChunkFeatures, FeatureStore
from visualbert_torch.data.masking import MLM_IGNORE, random_word
from visualbert_torch.data.pipeline import pad_to
from visualbert_torch.data.tokenization import BertTokenizer
from visualbert_torch.utils.images import image_wire_fields

# Det-tag → gender-neutral-name rendering (reference cycles this list by a
# per-example person counter in first-mention order, vcr_data_utils.py:14-38;
# the original r2c pipeline randomizes the choice).
GENDER_NEUTRAL_NAMES = [
    "casey", "riley", "jessie", "jackie", "avery", "jaime", "peyton",
    "kerry", "jody", "kendall", "frankie", "pat", "quinn",
]

Token = Union[str, Sequence[int]]


def render_tokens(
    mixed: Sequence[Token],
    objects: Sequence[str],
    tokenizer: BertTokenizer,
    rng=None,
    name_map: Optional[Dict[int, str]] = None,
) -> Tuple[List[str], List[List[int]]]:
    """Render mixed text/detection tokens to subwords.

    Person detections get a gender-neutral name, chosen at first mention —
    uniformly from ``GENDER_NEUTRAL_NAMES`` via the example's seeded ``rng``
    (reproducible train-time name diversity) or, with ``rng=None``, by the
    deterministic object-index cycle. Re-mentions reuse the first choice via
    ``name_map`` — pass the same (mutated-in-place) dict across the question
    and every answer choice so one example names its people consistently,
    like the reference's det_hist threading (vcr_data_utils.py:41-51).

    Returns (subwords, alignment) where alignment[i] is the list of object
    indices the i-th subword refers to ([] for plain words).
    """
    if name_map is None:
        name_map = {}
    subwords: List[str] = []
    align: List[List[int]] = []
    for tok in mixed:
        if isinstance(tok, str):
            pieces = tokenizer.tokenize(tok)
            subwords.extend(pieces)
            align.extend([[]] * len(pieces))
        else:
            obj_idxs = list(tok)
            for k, oi in enumerate(obj_idxs):
                if oi < len(objects) and objects[oi] == "person":
                    name = name_map.get(oi)
                    if name is None:
                        if rng is not None:
                            name = GENDER_NEUTRAL_NAMES[
                                int(rng.integers(len(GENDER_NEUTRAL_NAMES)))
                            ]
                        else:
                            name = GENDER_NEUTRAL_NAMES[oi % len(GENDER_NEUTRAL_NAMES)]
                        name_map[oi] = name
                else:
                    name = objects[oi] if oi < len(objects) else "thing"
                words = ([name] if k == 0 else ["and", name])
                for w in words:
                    pieces = tokenizer.tokenize(w)
                    subwords.extend(pieces)
                    align.extend([[oi]] * len(pieces))
    return subwords, align


class VCRDataset:
    def __init__(
        self,
        annotations: List[Dict],
        images: FeatureStore,
        tokenizer: BertTokenizer,
        *,
        max_seq_length: int = 128,
        max_boxes: int = 20,
        align_slots: int = 3,
        num_choices: int = 4,
    ):
        self.annotations = annotations
        self.images = images
        self.tokenizer = tokenizer
        self.max_seq_length = max_seq_length
        self.max_boxes = max_boxes
        self.align_slots = align_slots
        self.num_choices = num_choices

    def __len__(self):
        return len(self.annotations)

    def _encode_choice(self, q_sub, q_align, c_sub, c_align):
        T = self.max_seq_length
        qa, qb = list(q_sub), list(c_sub)
        aa, ab = list(q_align), list(c_align)
        while len(qa) + len(qb) > T - 3:
            if len(qa) > len(qb):
                qa.pop(), aa.pop()
            else:
                qb.pop(), ab.pop()
        tokens = ["[CLS]"] + qa + ["[SEP]"] + qb + ["[SEP]"]
        aligns = [[]] + aa + [[]] + ab + [[]]
        segs = [0] * (len(qa) + 2) + [1] * (len(qb) + 1)

        ids = np.zeros(T, np.int32)
        seg = np.zeros(T, np.int32)
        mask = np.zeros(T, np.int32)
        n = len(tokens)
        ids[:n] = self.tokenizer.convert_tokens_to_ids(tokens)
        seg[:n] = segs
        mask[:n] = 1
        return ids, seg, mask, aligns

    def __getitem__(self, args) -> Dict[str, np.ndarray]:
        i, rng = args if isinstance(args, tuple) else (args, None)
        item = self.annotations[i]
        objects = item["objects"]

        # one name_map across question + all choices: consistent person
        # names within the example, randomized across examples by the rng
        name_map: Dict[int, str] = {}
        q_sub, q_align = render_tokens(
            item["question"], objects, self.tokenizer, rng=rng, name_map=name_map
        )
        C = self.num_choices
        T = self.max_seq_length
        N, A = self.max_boxes, self.align_slots

        input_ids = np.zeros((C, T), np.int32)
        token_type = np.zeros((C, T), np.int32)
        input_mask = np.zeros((C, T), np.int32)
        # box→token alignment: for each box, the token positions referring to
        # it (-1 padded) — feeds image_text_alignment (modeling.py:1223-1245)
        alignment = np.full((C, N, A), -1, np.int32)

        for c, choice in enumerate(item["choices"]):
            c_sub, c_align = render_tokens(
                choice, objects, self.tokenizer, rng=rng, name_map=name_map
            )
            ids, seg, mask, aligns = self._encode_choice(q_sub, q_align, c_sub, c_align)
            input_ids[c], token_type[c], input_mask[c] = ids, seg, mask
            slots_used = np.zeros(N, np.int32)
            for pos, refs in enumerate(aligns):
                for oi in refs:
                    if oi < N and slots_used[oi] < A:
                        alignment[c, oi, slots_used[oi]] = pos
                        slots_used[oi] += 1

        img = self.images.get(str(item["image_id"]))
        boxes = pad_to(np.asarray(img["boxes"], np.float32), N, axis=0)
        classes = pad_to(np.asarray(img["classes"], np.int64).astype(np.int32), N, axis=0)
        n_boxes = min(len(img["boxes"]), N)
        box_mask = np.zeros(N, np.int32)
        box_mask[:n_boxes] = 1

        sample = {
            **image_wire_fields(img),
            "boxes": boxes,
            "box_mask": box_mask,
            "classes": classes,
            "input_ids": input_ids,
            "token_type_ids": token_type,
            "input_mask": input_mask,
            "image_text_alignment": alignment,
        }
        if "segms" in img:
            sample["segms"] = pad_to(np.asarray(img["segms"], np.float32), N, axis=0)
        if "label" in item:
            sample["label"] = np.int32(item["label"])
        return sample


def make_synthetic(n: int, tokenizer: BertTokenizer, img_size: int = 32,
                   n_boxes: int = 3, seed: int = 0):
    """Learnable toy VCR: the correct answer names the object whose box
    region is 'bright' in the image."""
    rng = np.random.default_rng(seed)
    words = [w for w in tokenizer.vocab if not w.startswith("[") and not w.startswith("##")]
    annotations, chunk = [], {}
    for i in range(n):
        label = int(rng.integers(4))
        img = rng.normal(size=(img_size, img_size, 3)).astype(np.float32) * 0.1
        boxes = np.zeros((n_boxes, 4), np.float32)
        for b in range(n_boxes):
            x = rng.uniform(0, img_size - 12)
            y = rng.uniform(0, img_size - 12)
            boxes[b] = [x, y, x + 10, y + 10]
        bright = label % n_boxes
        x1, y1, x2, y2 = boxes[bright].astype(int)
        img[y1:y2, x1:x2] += 3.0
        chunk[str(i)] = {
            "image": img,
            "boxes": boxes,
            "classes": rng.integers(1, 81, size=n_boxes),
            "segms": rng.random((n_boxes, 14, 14)).astype(np.float32),
        }
        choices = []
        for c in range(4):
            ref_obj = c % n_boxes
            choices.append([words[c], [ref_obj], words[(c + 7) % len(words)]])
        annotations.append({
            "image_id": str(i),
            "question": [words[10], [0], words[11]],
            "choices": choices,
            "label": label,
            "objects": ["person"] * n_boxes,
        })
    return annotations, ChunkFeatures(chunk)


class VCRPretrainDataset(VCRDataset):
    """VCR-domain pretraining (reference ``complete_shuffle``,
    vcr.py:187-193,249-259): every (item, choice) pair becomes ONE masked-LM
    example — len(annotations) × num_choices examples of question+choice text
    with 80/10/10 masking (15 %) over the image's detections."""

    def __init__(self, *args, n_mlm_predictions: int = 16, **kw):
        super().__init__(*args, **kw)
        self.n_mlm_predictions = n_mlm_predictions

    def __len__(self):
        return len(self.annotations) * self.num_choices

    def __getitem__(self, args):
        idx, rng = args
        i, c = divmod(idx, self.num_choices)
        item = self.annotations[i]
        objects = item["objects"]

        name_map: Dict[int, str] = {}
        q_sub, q_align = render_tokens(
            item["question"], objects, self.tokenizer, rng=rng, name_map=name_map
        )
        c_sub, c_align = render_tokens(
            item["choices"][c], objects, self.tokenizer, rng=rng, name_map=name_map
        )
        q_sub, q_lbl = random_word(q_sub, self.tokenizer, rng)
        c_sub, c_lbl = random_word(c_sub, self.tokenizer, rng)

        T = self.max_seq_length
        qa, qb = list(q_sub), list(c_sub)
        la, lb = list(q_lbl), list(c_lbl)
        aa, ab = list(q_align), list(c_align)
        while len(qa) + len(qb) > T - 3:
            if len(qa) > len(qb):
                qa.pop(), la.pop(), aa.pop()
            else:
                qb.pop(), lb.pop(), ab.pop()
        tokens = ["[CLS]"] + qa + ["[SEP]"] + qb + ["[SEP]"]
        labels = [MLM_IGNORE] + la + [MLM_IGNORE] + lb + [MLM_IGNORE]
        aligns = [[]] + aa + [[]] + ab + [[]]
        segs = [0] * (len(qa) + 2) + [1] * (len(qb) + 1)

        N, A = self.max_boxes, self.align_slots
        ids = np.zeros((1, T), np.int32)
        seg = np.zeros((1, T), np.int32)
        mask = np.zeros((1, T), np.int32)
        lm = np.full((1, T), MLM_IGNORE, np.int32)
        alignment = np.full((1, N, A), -1, np.int32)
        n = len(tokens)
        ids[0, :n] = self.tokenizer.convert_tokens_to_ids(tokens)
        seg[0, :n] = segs
        mask[0, :n] = 1
        lm[0, :n] = labels
        slots_used = np.zeros(N, np.int32)
        for pos, refs in enumerate(aligns):
            for oi in refs:
                if oi < N and slots_used[oi] < A:
                    alignment[0, oi, slots_used[oi]] = pos
                    slots_used[oi] += 1

        pos = np.flatnonzero(lm[0] != MLM_IGNORE)[: self.n_mlm_predictions]
        positions = np.zeros((1, self.n_mlm_predictions), np.int32)
        positions[0, : len(pos)] = pos

        img = self.images.get(str(item["image_id"]))
        boxes = pad_to(np.asarray(img["boxes"], np.float32), N, axis=0)
        classes = pad_to(np.asarray(img["classes"], np.int64).astype(np.int32), N, axis=0)
        n_boxes = min(len(img["boxes"]), N)
        box_mask = np.zeros(N, np.int32)
        box_mask[:n_boxes] = 1
        sample = {
            **image_wire_fields(img),
            "boxes": boxes,
            "box_mask": box_mask,
            "classes": classes,
            "input_ids": ids,
            "token_type_ids": seg,
            "input_mask": mask,
            "masked_lm_labels": lm,
            "mlm_positions": positions,
            "image_text_alignment": alignment,
        }
        if "segms" in img:
            sample["segms"] = pad_to(np.asarray(img["segms"], np.float32), N, axis=0)
        return sample
