"""Convert official dataset releases into the annotation formats of the
port's tasks: the port's own copy of ``visualbert_tpu/tools/prepare_data.py``
(the reference's assorted prep scripts,
``unsupervised_visualbert/data/*/process_*``, and the Pythia imdb
preprocessing the visualbert stack consumes). Its outputs equal the JAX
tool's.

All functions are pure json/XML reshaping; features come from
``convert_tsv_to_h5`` or ``tools/extract_features.py``.
"""

from __future__ import annotations

import collections
import json
import os
import re
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional


def prepare_coco_captions(captions_json: str, out_path: str) -> int:
    """COCO ``captions_*.json`` → [{"image_id", "captions": [...]}]."""
    with open(captions_json) as f:
        data = json.load(f)
    caps: Dict[int, List[str]] = collections.defaultdict(list)
    for ann in data["annotations"]:
        caps[int(ann["image_id"])].append(ann["caption"])
    out = [{"image_id": str(k), "captions": v} for k, v in sorted(caps.items())]
    with open(out_path, "w") as f:
        json.dump(out, f)
    return len(out)


_PUNCT = re.compile(r"[^\w\s]")


def _question_tokens(q: str) -> List[str]:
    return _PUNCT.sub("", q.lower()).split()


def prepare_vqa(
    questions_json: str,
    out_path: str,
    annotations_json: Optional[str] = None,
) -> int:
    """VQA2 ``v2_OpenEnded_*_questions.json`` (+ optional annotations) →
    imdb-style [{"question_tokens", "image_id", "question_id", "answers"}]."""
    with open(questions_json) as f:
        questions = json.load(f)["questions"]
    answers_by_qid: Dict[int, List[str]] = {}
    if annotations_json:
        with open(annotations_json) as f:
            for ann in json.load(f)["annotations"]:
                answers_by_qid[int(ann["question_id"])] = [
                    a["answer"] for a in ann["answers"]
                ]
    out = []
    for q in questions:
        item = {
            "question_tokens": _question_tokens(q["question"]),
            "image_id": str(q["image_id"]),
            "question_id": int(q["question_id"]),
        }
        if answers_by_qid:
            item["answers"] = answers_by_qid.get(int(q["question_id"]), [])
        out.append(item)
    with open(out_path, "w") as f:
        json.dump(out, f)
    return len(out)


def prepare_nlvr2(jsonl_path: str, out_path: str) -> int:
    """Official NLVR2 jsonl → [{"identifier","sentence","label","img0","img1"}].
    Image ids follow the official naming: ``<identifier minus sentence id>-img{0,1}``."""
    out = []
    with open(jsonl_path) as f:
        for line in f:
            if not line.strip():
                continue
            row = json.loads(line)
            ident = row["identifier"]
            base = "-".join(ident.split("-")[:-1])
            out.append({
                "identifier": ident,
                "sentence": row["sentence"],
                "label": 1 if str(row.get("label", "")).lower() == "true" else 0,
                "img0": f"{base}-img0",
                "img1": f"{base}-img1",
            })
    with open(out_path, "w") as f:
        json.dump(out, f)
    return len(out)


def prepare_flickr30k_entities(
    sentences_dir: str,
    annotations_dir: str,
    image_ids: List[str],
    out_path: str,
    box_source: Dict[str, List[List[float]]],
    iou_threshold: float = 0.5,
) -> int:
    """Flickr30kEntities sentence files + XML box annotations → our
    grounding format. ``box_source`` maps image_id → detector boxes (the
    region proposals the features were extracted from); each entity's gold
    regions are proposals with IoU ≥ threshold against a gold box
    (the BAN preprocessing the reference consumes, flickr_ban/dataset.py)."""

    def iou(a, b):
        ax1, ay1, ax2, ay2 = a
        bx1, by1, bx2, by2 = b
        ix1, iy1 = max(ax1, bx1), max(ay1, by1)
        ix2, iy2 = min(ax2, bx2), min(ay2, by2)
        iw, ih = max(ix2 - ix1, 0), max(iy2 - iy1, 0)
        inter = iw * ih
        union = (ax2 - ax1) * (ay2 - ay1) + (bx2 - bx1) * (by2 - by1) - inter
        return inter / union if union > 0 else 0.0

    ent_re = re.compile(r"\[/EN#(\d+)(?:/[^\s\]]+)+ ([^\]]+)\]")
    out = []
    for image_id in image_ids:
        sent_file = os.path.join(sentences_dir, f"{image_id}.txt")
        xml_file = os.path.join(annotations_dir, f"{image_id}.xml")
        if not (os.path.exists(sent_file) and os.path.exists(xml_file)):
            continue
        # gold boxes per entity chain id
        gold: Dict[str, List[List[float]]] = collections.defaultdict(list)
        root = ET.parse(xml_file).getroot()
        for obj in root.iter("object"):
            names = [n.text for n in obj.findall("name")]
            box = obj.find("bndbox")
            if box is None:
                continue
            coords = [float(box.find(t).text) for t in ("xmin", "ymin", "xmax", "ymax")]
            for n in names:
                gold[n].append(coords)
        proposals = box_source.get(image_id, [])

        with open(sent_file) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                words: List[str] = []
                entities = []
                pos = 0
                for m in ent_re.finditer(line):
                    words.extend(line[pos : m.start()].split())
                    first_word = len(words)
                    phrase_words = m.group(2).split()
                    words.extend(phrase_words)
                    chain = m.group(1)
                    targets = [
                        i for i, p in enumerate(proposals)
                        if any(iou(p, g) >= iou_threshold for g in gold.get(chain, []))
                    ]
                    # Chains WITH gold boxes are kept even when no proposal
                    # reaches the IoU threshold — the zero-label slot is a
                    # guaranteed miss that caps upperbound_accuracy, matching
                    # the reference (flickr_ban/dataset.py:309-311 appends
                    # empty get_match_index results; only chains absent from
                    # target_bboxes are skipped, dataset.py:299-302).
                    if gold.get(chain):
                        entities.append({"word_index": first_word, "region_targets": targets})
                    pos = m.end()
                words.extend(line[pos:].split())
                if entities:
                    out.append({"image_id": image_id, "words": words, "entities": entities})
    with open(out_path, "w") as f:
        json.dump(out, f)
    return len(out)


def prepare_vcr(
    jsonl_path: str,
    out_path: str,
    mode: str = "answer",
) -> int:
    """Official VCR jsonl → our annotation format.

    mode="answer": Q→A (choices = answer_choices).
    mode="rationale": QA→R (question := question + correct answer;
    choices = rationale_choices) — the reference's two fine-tune modes
    (vcr.py:118-119, fine-tune-qa/qar configs).

    Detection references stay as int lists inside token streams; the
    ``objects`` list names each detection's class.
    """
    assert mode in ("answer", "rationale"), mode
    out = []
    with open(jsonl_path) as f:
        for line in f:
            if not line.strip():
                continue
            row = json.loads(line)
            question = list(row["question"])
            if mode == "answer":
                choices = row["answer_choices"]
                label = row.get("answer_label")
            else:
                right_answer = row["answer_choices"][row["answer_label"]]
                question = question + list(right_answer)
                choices = row["rationale_choices"]
                label = row.get("rationale_label")
            item = {
                "image_id": row["img_id"],
                "question": question,
                "choices": choices,
                "objects": row.get("objects", []),
            }
            if label is not None:
                item["label"] = int(label)
            out.append(item)
    with open(out_path, "w") as f:
        json.dump(out, f)
    return len(out)


def prepare_conceptual_captions(
    tsv_path: str, out_path: str, image_id_prefix: str = ""
) -> int:
    """Conceptual Captions release TSV (``caption\\turl`` per line) → this
    framework's unsupervised-pretraining annotations
    ``[{"image_id", "sentence"}]``.

    Reference: ``unsupervised_visualbert/src/tools/
    create_cc_data_lxmert_style.py:1`` — the image id is the line index
    (the downloader saves ``<i>.jpg`` in release order and the BUTD
    extractor keys features by that name); ``image_id_prefix`` prepends a
    split/dir tag the same way the reference embeds its target dir.
    """
    out = []
    with open(tsv_path) as f:
        for i, line in enumerate(f):
            if not line.strip():
                continue
            caption = line.rstrip("\n").split("\t", 1)[0]
            out.append({"image_id": f"{image_id_prefix}{i}", "sentence": caption})
    with open(out_path, "w") as f:
        json.dump(out, f)
    return len(out)


def prepare_gqa(
    questions_json: str, out_path: str, style: str = "vqa"
) -> int:
    """GQA ``*_balanced_questions.json`` (dict question_id → datum) → task
    annotations.

    ``style="vqa"``: the unsup_vqa fine-tune contract
    ``[{"question_id", "image_id", "sent", "label": {answer: 1.0}}]``
    (reference ``unsupervised_visualbert/data/gqa/process_raw_data_scripts/
    process_data.py:1``, which emits the same lxmert-style records).
    ``style="pretrain"``: QA-co-training pretrain records
    ``[{"image_id", "sentence", "ans"}]`` consumed by ``unsup_pretrain``
    (answers relabeled through the AnswerTable there).
    """
    assert style in ("vqa", "pretrain"), style
    with open(questions_json) as f:
        data = json.load(f)
    out = []
    for key in sorted(data):
        datum = data[key]
        if style == "vqa":
            item = {
                "question_id": key,
                "image_id": str(datum["imageId"]),
                "sent": datum["question"],
            }
            if "answer" in datum:
                item["label"] = {datum["answer"]: 1.0}
        else:
            item = {
                "image_id": str(datum["imageId"]),
                "sentence": datum["question"],
            }
            if "answer" in datum:
                item["ans"] = datum["answer"]
        out.append(item)
    with open(out_path, "w") as f:
        json.dump(out, f)
    return len(out)


def prepare_open_images(listing_paths, out_path: str) -> int:
    """Open Images id listings (txt files, one image id per line — the
    BUTD extraction manifests) → image-only pretraining annotations
    ``[{"image_id"}]`` (no sentence → the ``unsup_pretrain`` image-only
    hybrid source).

    Reference: ``unsupervised_visualbert/src/tools/
    create_open_image_data_lxmert_style.py:1`` (walks the feature dir's txt
    manifests and emits empty-sentence records; here the no-sentence form
    routes to the image-only batcher directly). ``listing_paths`` may be a
    directory (every ``*.txt`` inside, sorted) or a list of files.
    """
    if isinstance(listing_paths, str) and os.path.isdir(listing_paths):
        files = sorted(
            os.path.join(listing_paths, n)
            for n in os.listdir(listing_paths)
            if n.endswith(".txt")
        )
    elif isinstance(listing_paths, str):
        files = [listing_paths]
    else:
        files = list(listing_paths)
    out = []
    for path in files:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append({"image_id": line})
    with open(out_path, "w") as f:
        json.dump(out, f)
    return len(out)
