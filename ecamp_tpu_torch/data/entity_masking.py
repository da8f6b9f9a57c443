"""Entity-centred context masking and template down-weighting (host side),
the counterpart of `ecamp_tpu/data/entity_masking.py`, reference
pretrain_datasets.py:60-191.

  * `context_mask` (:60-110): the reference's sequential token walk,
    vectorised and bit-exact with it, RNG stream included: '##'
    continuation runs follow their head's [MASK]=3 decision, 75% / 70%
    random masking depending on whether any entity is present, a second
    75% pass over entity positions, and the 2-token context window before
    each entity ('.'=16 excluded) recorded for the weight rebalance. The
    reference's context-masking branch is dead (its condition re-tests the
    entity token, :93): contexts are recorded, never force-masked.
  * `template_weights`: "there is no (evidence of)" -> weight 0.05
    (:143-170); `rebalance_weights`: the weight-rebalance algebra
    (:174-184).
"""

from __future__ import annotations

import random
from typing import Dict, List, Sequence, Tuple

import numpy as np

ENTITIES = frozenset([
    'abnormality', 'abscess', 'aerate', 'aorta', 'atelectasis',
    'bronchiectasis', 'calcification', 'cardiomediastinal', 'cardiomegaly',
    'catheter', 'chf', 'collapse', 'congestion', 'consolidation', 'contour',
    'COPD', 'deformity', 'dilation', 'distention', 'edema', 'effusion',
    'embolism', 'emphysema', 'engorgement', 'fibrosis', 'fracture',
    'granuloma', 'hernia', 'hilar', 'hyperinflate', 'hemidiaphragm',
    'infiltrate', 'mass', 'nodule', 'obscure', 'opacity', 'perihilar',
    'pneumonia', 'pneumothorax', 'sarcoidosis', 'silhouette', 'thickening',
    'tuberculosis', 'vasculature',
])  # pretrain_datasets.py:17-22

TEMPLATE_FULL = (219, 149, 152, 422, 158)  # "there is no evidence of"
TEMPLATE_SHORT = (219, 149, 152)           # "there is no"
MASK_ID = 3
PAD_ID = 0
PERIOD_ID = 16
DIMINISH_WEIGHT = 0.05

# id(idx_to_word) -> (idx_to_word, is-'##' table, is-entity table); the
# dict itself is kept and compared, so a recycled id never aliases
_LUT_CACHE: Dict[int, Tuple[Dict[int, str], np.ndarray, np.ndarray]] = {}


def _vocab_luts(idx_to_word: Dict[int, str]
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-vocab boolean tables (is '##' continuation, is entity), built
    once per vocabulary."""
    key = id(idx_to_word)
    hit = _LUT_CACHE.get(key)
    if hit is not None and hit[0] is idx_to_word:
        return hit[1], hit[2]
    size = max(idx_to_word) + 1
    cont = np.zeros((size,), np.bool_)
    ent = np.zeros((size,), np.bool_)
    for i, w in idx_to_word.items():
        cont[i] = w.startswith("##")
        ent[i] = w in ENTITIES
    _LUT_CACHE[key] = (idx_to_word, cont, ent)
    return cont, ent


def context_mask(ids: np.ndarray, idx_to_word: Dict[int, str],
                 rng: random.Random) -> Tuple[np.ndarray, List[int]]:
    """Entity-centred masking of a 1-D id sequence. Returns (masked_ids,
    mask_pos), mask_pos the entity-context positions.

    The walk's properties that make the vectorised form exact: every '##'
    token is skipped before the rng draw, so draws map in order onto the
    non-'##' positions before the first PAD; at a position's draw it is
    never yet a context position, and it is an entity position iff its id
    is an entity; and every test reads the original ids, so a '##' run is
    masked iff its head was."""
    ids = np.asarray(ids)
    masked = ids.copy()
    L = ids.shape[0]
    cont_lut, ent_lut = _vocab_luts(idx_to_word)
    cont = cont_lut[ids]
    ent = ent_lut[ids]

    # the walk covers 1..L-2 and stops at the first PAD
    pads = np.flatnonzero(ids[1:L - 1] == PAD_ID)
    stop = (1 + pads[0]) if len(pads) else (L - 1)
    entity_exist = bool(ent[1:L - 1].any())  # over the full range

    walk = np.arange(1, stop)
    heads = walk[~cont[walk]]  # the draw positions, in order
    probs = np.fromiter((rng.random() for _ in range(len(heads))),
                        np.float64, count=len(heads))
    if entity_exist:
        decide = (probs < 0.7) & ~ent[heads]
    else:
        decide = probs < 0.75
    head_masked = np.zeros((L,), np.bool_)
    head_masked[heads[decide]] = True

    # each '##' run follows its head: the last non-'##' index at or before
    # it (position 0 is [CLS] and never masked)
    in_walk = np.zeros((L,), np.bool_)
    in_walk[walk] = True
    run_head = np.maximum.accumulate(
        np.where(~(cont & in_walk), np.arange(L), 0))
    masked[head_masked[run_head] & in_walk] = MASK_ID

    entity_pos = [int(i) for i in heads[ent[heads]]]
    mask_pos: List[int] = []
    seen = set()
    for i in entity_pos:
        for j in (1, 2):
            if i - j <= 0:
                break
            if ids[i - j] != PERIOD_ID and (i - j) not in seen:
                seen.add(i - j)
                mask_pos.append(i - j)

    # second pass: one draw per entity position, in order
    for i in entity_pos:
        if rng.random() < 0.75:
            masked[i] = MASK_ID
    return masked, mask_pos


def template_weights(ids: np.ndarray, max_len: int
                     ) -> Tuple[np.ndarray, List[int], int]:
    """Down-weight negated-finding template tokens to 0.05
    (pretrain_datasets.py:143-170), matching left to right without
    overlap. Returns (weights, diminish_pos, count)."""
    weights = np.ones((max_len,), dtype=np.float32)
    diminish_pos: List[int] = []
    cnt = 0
    a = np.asarray(ids)
    L = len(a)
    # both templates share the 3-token prefix: matches start only there
    cand = np.flatnonzero((a[:L - 2] == TEMPLATE_SHORT[0])
                          & (a[1:L - 1] == TEMPLATE_SHORT[1])
                          & (a[2:] == TEMPLATE_SHORT[2]))
    i = 0
    for c in cand:
        c = int(c)
        if c < i or c >= L - 4:  # the reference loop's bound
            continue
        n = 5 if (a[c + 3] == TEMPLATE_FULL[3]
                  and a[c + 4] == TEMPLATE_FULL[4]) else 3
        weights[c:c + n] = DIMINISH_WEIGHT
        diminish_pos.extend(range(c, c + n))
        cnt += n
        i = c + n
    return weights, diminish_pos, cnt


def rebalance_weights(weights: np.ndarray, mask_pos: Sequence[int],
                      diminish_pos: Sequence[int], diminish_cnt: int,
                      max_len: int) -> np.ndarray:
    """The weight-rebalance algebra (pretrain_datasets.py:174-184)."""
    weights = weights.copy()
    len_dm = len([p for p in mask_pos if p in diminish_pos])
    mask_cnt = len(mask_pos)
    if mask_cnt > 0 and diminish_cnt > 0:
        expand = (0.95 * (diminish_cnt - len_dm) + mask_cnt) / \
            (mask_cnt - 0.95 * len_dm)
        for p in mask_pos:
            weights[p] = weights[p] * expand
    elif diminish_cnt > 0:
        weights = weights * (max_len / (max_len - 0.95 * diminish_cnt))
    return weights


def build_text_example(report: str, llm_output: str, tokenizer,
                       rng: random.Random, max_len: int = 256
                       ) -> Dict[str, np.ndarray]:
    """The text side of one sample (pretrain_datasets.py:116-191): the LLM
    sentence inserted at a random sentence boundary (p = 0.8), tokenize,
    template weights, entity-context masking, weight rebalance."""
    sentences = report.split(".")
    if rng.random() < 0.8:
        loc = rng.randint(0, len(sentences))
        sent = "".join(s + "." for s in sentences[:loc])
        sent += llm_output
        sent += "".join(s + "." for s in sentences[loc:])
    else:
        sent = report
    sent = "[CLS] " + sent.replace("..", ".")

    enc = tokenizer.encode(sent, max_length=max_len, pad_to=max_len)
    weights, diminish_pos, diminish_cnt = template_weights(enc.ids, max_len)
    masked_ids, mask_pos = context_mask(enc.ids, tokenizer.ids_to_tokens,
                                        rng)
    weights = rebalance_weights(weights, mask_pos, diminish_pos,
                                diminish_cnt, max_len)
    return {
        "ids": masked_ids.astype(np.int32),
        "labels": enc.ids.astype(np.int32),
        "attention_mask": enc.attention_mask,
        "type_ids": enc.type_ids,
        "weights": weights,
    }
