"""Offline dataset-construction tools: sub-instruction segmentation +
noun-phrase annotation.

Rebuild of the one-off metadata pipeline
(VLN-HAMT/finetune_src/r2r/data_utils.py:119-450): fuzzy-match FGR2R
sub-instruction chunks onto R2R BERT-token spans (score-maximising sliding
window), then extract nouns per sub-instruction (spaCy noun chunks with an
exclusion list in the reference).  spaCy/fuzzywuzzy are optional here: the
fuzzy ratio falls back to difflib.SequenceMatcher and noun extraction to a
stopword-heuristic tagger, so the tool runs in minimal environments; outputs
use the exact JSON schema the training pipeline consumes
(instr_segmentation_indices / noun_phrase_indices per instruction_id).

Not on the device path: it runs once per dataset.  The port's own copy of
the JAX package's module.
"""

from __future__ import annotations

import string
from difflib import SequenceMatcher
from typing import Iterable

try:  # optional, matches the reference scorer exactly when present
    from fuzzywuzzy import fuzz

    def _ratio(a: str, b: str) -> float:
        return float(fuzz.ratio(a, b))
except ImportError:
    def _ratio(a: str, b: str) -> float:
        return 100.0 * SequenceMatcher(None, a, b).ratio()

try:  # optional
    import spacy
    try:
        _NLP = spacy.load("en_core_web_sm")
    except Exception:
        _NLP = None
except ImportError:
    _NLP = None

# words excluded from noun-phrase candidates (rooms/directions are scenery,
# not imaginable landmarks — mirrors the reference's exclusion lists)
EXCLUDED_NOUNS = {
    "left", "right", "straight", "front", "back", "top", "bottom", "end",
    "side", "way", "direction", "turn", "step", "steps", "stop", "start",
    "one", "it", "them", "that", "this", "you",
}
STOPWORDS = {
    "a", "an", "the", "and", "or", "of", "to", "in", "on", "at", "into",
    "onto", "with", "from", "by", "up", "down", "through", "past", "is",
    "are", "be", "go", "walk", "take", "make", "wait", "then", "until",
    "your", "before", "after", "towards", "toward", "near", "next",
}


def filter_punctuation_with_indices(tokens: list[str]):
    """(data_utils.py:120-127)"""
    filtered, indices = [], []
    for i, tok in enumerate(tokens):
        if tok not in string.punctuation:
            filtered.append(tok)
            indices.append(i)
    return filtered, indices


def find_best_segment(instr_tokens: list[str], sub_instr_tokens: list[str]):
    """Best-matching token window (start, end_exclusive, score)
    (data_utils.py:130-149)."""
    filtered, indices = filter_punctuation_with_indices(instr_tokens)
    if not sub_instr_tokens or len(filtered) < len(sub_instr_tokens):
        return (0, 0, 0.0)
    best = (0, 0, -1.0)
    target = " ".join(sub_instr_tokens)
    for i in range(len(filtered) - len(sub_instr_tokens) + 1):
        window = " ".join(filtered[i: i + len(sub_instr_tokens)])
        score = _ratio(window, target)
        if score > best[2]:
            best = (indices[i],
                    indices[i + len(sub_instr_tokens) - 1] + 1, score)
    return best


def merge_subword_tokens(tokens: list[str]):
    """Collapse '##'-continuation wordpieces; returns (merged, index_map)
    (data_utils.py:222-242)."""
    merged, mapping = [], []
    for i, tok in enumerate(tokens):
        if tok.startswith("##") and merged:
            merged[-1] += tok[2:]
        else:
            merged.append(tok[2:] if tok.startswith("##") else tok)
            mapping.append(i)
    return merged, mapping


def extract_nouns(words: list[str]) -> list[tuple[str, int]]:
    """(word, index) noun candidates.  spaCy noun chunks when available
    (data_utils.py:208-220); else a stopword-filtered heuristic."""
    if _NLP is not None:
        doc = _NLP(" ".join(words))
        out = []
        for chunk in doc.noun_chunks:
            for token in chunk:
                if token.pos_ == "NOUN" and token.i < len(words):
                    out.append((token.text, token.i))
        return out
    out = []
    for i, w in enumerate(words):
        wl = w.lower().strip(string.punctuation)
        if not wl or wl in STOPWORDS or wl in string.punctuation:
            continue
        if wl.isalpha() and len(wl) > 2:
            out.append((wl, i))
    return out


def noun_phrases_for_sub_instr(sub_tokens: list[str],
                               excluded: Iterable[str] = EXCLUDED_NOUNS):
    """Noun spans as (start, end) inclusive indices into `sub_tokens`
    (wordpiece space), excluding scenery words
    (extract_noun_phrases_after_merging_split_tokens, data_utils.py:267+)."""
    merged, mapping = merge_subword_tokens(sub_tokens)
    nouns = extract_nouns(merged)
    nouns = [(w, i) for (w, i) in nouns
             if w == "room" or not any(f in w for f in excluded)]
    spans = []
    for _, mi in nouns:
        start = mapping[mi]
        end = mapping[mi + 1] - 1 if mi + 1 < len(mapping) \
            else len(sub_tokens) - 1
        spans.append((start, end))
    # dedupe, keep order
    seen, out = set(), []
    for s in spans:
        if s not in seen:
            out.append(s)
            seen.add(s)
    return out


def build_sub_instr_metadata(
    instr_id: str,
    instr_tokens: list[str],
    sub_instr_token_lists: list[list[str]],
    path_id=None,
) -> dict:
    """One instruction's metadata record in the pipeline schema
    (construct_sub_instr_segmentations_score_maximize +
    annotate_noun_phrases_from_subinstrs, data_utils.py:152-450)."""
    seg_idxs = []
    np_idxs = []
    np_texts = []
    for sub_tokens in sub_instr_token_lists:
        start, end_ex, _ = find_best_segment(instr_tokens, sub_tokens)
        seg_idxs.append((start, end_ex - 1))
        local_spans = noun_phrases_for_sub_instr(sub_tokens)
        np_idxs.append([(start + lo, start + hi) for lo, hi in local_spans])
        np_texts.append([" ".join(sub_tokens[lo: hi + 1])
                         for lo, hi in local_spans])
    return {
        "path_id": path_id,
        "instruction_id": instr_id,
        "trajectory_length": len(sub_instr_token_lists),
        "instruction_tokens": instr_tokens,
        "sub-instructions_tokens": sub_instr_token_lists,
        "instr_segmentation_indices": seg_idxs,
        "noun_phrase_indices": np_idxs,
        "noun_phrases": np_texts,
    }
