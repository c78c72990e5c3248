"""UAX#9 bidirectional reordering (explicit levels, brackets, marks).

The reference does no bidi at all (plain ``draw.text``, RepText/infer.py:74-76
— SURVEY.md §2.1 "Arabic caveat"); this module implements the full Unicode
Bidirectional Algorithm needed to render mixed Arabic / Latin / number /
punctuation text correctly for an LTR glyph renderer:

- P2/P3 base direction from the first strong character (skipping isolated
  sequences per the isolate-aware P2);
- X1-X8 explicit embedding/override state machine (LRE/RLE/LRO/RLO/PDF with
  the 125-depth directional status stack, overflow counters) and the isolate
  initiators LRI/RLI/FSI + PDI (X5a-X5c, X6a), including the FSI
  first-strong scan;
- X9 removal of embedding/override/PDF/BN characters; X10 isolating run
  sequences, each resolved with its own sos/eos (level-run linking across
  isolate initiator -> matching PDI);
- W1-W7 weak-type resolution per run sequence with EN and AN kept SEPARATE
  (Arabic numbers after Arabic letters become AN; European numbers after L
  stay EN — this is the common mixed "Arabic + digits" case the collapsed-
  class version got structurally wrong);
- N0 bracket pairs (BD16 stack pairing + strong-context resolution at the
  run sequence's embedding direction, incl. the trailing-NSM adjustment);
- N1/N2 neutral resolution with EN/AN acting as R, sos/eos at the ends;
- I1/I2 implicit levels relative to each sequence's embedding level,
  L1 trailing-whitespace/isolate reset, L2 run reversal, L4 mirroring at
  odd levels;
- directional marks LRM/RLM/ALM participate as strong types, and all
  zero-width formatting characters (marks, embeddings, isolates, PDI) are
  removed from the visual output.

Behavior is pinned against GNU FriBidi (the UAX#9 reference implementation)
by recorded fixtures (tests/fixtures/bidi_cases.json) and a live randomized
cross-check when libfribidi is present (tests/test_bidi.py).
"""

from __future__ import annotations

import unicodedata
from typing import List, Optional, Sequence, Tuple

# Zero-width directional formatting characters never drawn by the renderer.
_REMOVED = {
    0x200E, 0x200F, 0x061C,              # LRM, RLM, ALM (strong, zero-width)
    0x202A, 0x202B, 0x202C, 0x202D, 0x202E,   # LRE, RLE, PDF, LRO, RLO
    0x2066, 0x2067, 0x2068, 0x2069,      # LRI, RLI, FSI, PDI
}

# Common bidi-mirrored pairs (BidiBrackets + BidiMirroring core set)
_MIRROR_PAIRS = {
    "(": ")", ")": "(", "[": "]", "]": "[", "{": "}", "}": "{",
    "<": ">", ">": "<", "«": "»", "»": "«", "‹": "›", "›": "‹",
    "⟨": "⟩", "⟩": "⟨", "“": "”", "”": "“", "‘": "’", "’": "‘",
}
# Canonical open->close bracket pairs for BD16 (subset: ASCII + common)
_BRACKETS = {"(": ")", "[": "]", "{": "}", "⟨": "⟩"}
_BRACKETS_CLOSE = {v: k for k, v in _BRACKETS.items()}

_ISOLATE_INIT = ("LRI", "RLI", "FSI")
_MAX_DEPTH = 125


def _cls(ch: str) -> str:
    b = unicodedata.bidirectional(ch)
    return b if b else "ON"  # unassigned -> neutral


def _matching_pdi(raw: Sequence[str], i: int) -> int:
    """BD9: index of the PDI matching the isolate initiator at ``i``
    (len(raw) when unmatched)."""
    depth = 1
    for j in range(i + 1, len(raw)):
        t = raw[j]
        if t in _ISOLATE_INIT:
            depth += 1
        elif t == "PDI":
            depth -= 1
            if depth == 0:
                return j
    return len(raw)


def _first_strong(raw: Sequence[str], start: int, end: int) -> Optional[str]:
    """P2 over raw[start:end]: first strong type, skipping isolated runs."""
    i = start
    while i < end:
        t = raw[i]
        if t in _ISOLATE_INIT:
            i = _matching_pdi(raw, i) + 1
            continue
        if t == "L":
            return "L"
        if t in ("R", "AL"):
            return "R"
        i += 1
    return None


def needs_bidi(text: str) -> bool:
    """True when the text requires bidi processing before LTR rendering:
    any RTL-class character (R/AL/AN) or any directional formatting
    character (marks, embeddings, overrides, isolates — which must at
    minimum be stripped so the renderer never draws them)."""
    return any(
        ord(ch) in _REMOVED or _cls(ch) in ("R", "AL", "AN")
        for ch in text
    )


def base_direction(text: str, default: str = "ltr") -> str:
    """P2/P3: first strong character decides the paragraph direction
    (characters between an isolate initiator and its matching PDI are
    skipped, per the isolate-aware P2)."""
    raw = [_cls(c) for c in text]
    s = _first_strong(raw, 0, len(raw))
    if s == "R":
        return "rtl"
    if s == "L":
        return "ltr"
    return default


def _explicit_pass(raw: List[str], base_level: int
                   ) -> Tuple[List[int], List[str], List[bool]]:
    """X1-X8: explicit embedding levels + overrides; X9 marks removals.

    Returns (levels, types-after-override, removed-by-X9 mask). Isolate
    initiators and PDI are NOT removed here (they participate in the N rules
    as neutrals, X10); LRE/RLE/LRO/RLO/PDF/BN are.
    """
    n = len(raw)
    levels = [base_level] * n
    types = list(raw)
    removed = [False] * n
    # directional status stack: (embedding level, override in {N,L,R}, isolate)
    stack: List[Tuple[int, str, bool]] = [(base_level, "N", False)]
    overflow_iso = overflow_emb = valid_iso = 0

    for i in range(n):
        t = raw[i]
        if t in ("RLE", "LRE", "RLO", "LRO"):                      # X2-X5
            removed[i] = True
            levels[i] = stack[-1][0]
            if overflow_iso or overflow_emb:
                if not overflow_iso:
                    overflow_emb += 1
                continue
            cur = stack[-1][0]
            new = (cur + 1) | 1 if t[0] == "R" else (cur + 2) & ~1
            if new <= _MAX_DEPTH:
                override = {"RLO": "R", "LRO": "L"}.get(t, "N")
                stack.append((new, override, False))
            else:
                overflow_emb += 1
        elif t in _ISOLATE_INIT:                                   # X5a-X5c
            eff = t
            if t == "FSI":
                end = _matching_pdi(raw, i)
                eff = "RLI" if _first_strong(raw, i + 1, end) == "R" else "LRI"
            cur, override, _ = stack[-1]
            levels[i] = cur
            if override != "N":
                types[i] = override
            if overflow_iso or overflow_emb:
                overflow_iso += 1
                continue
            new = (cur + 1) | 1 if eff == "RLI" else (cur + 2) & ~1
            if new <= _MAX_DEPTH:
                valid_iso += 1
                stack.append((new, "N", True))
            else:
                overflow_iso += 1
        elif t == "PDI":                                           # X6a
            if overflow_iso:
                overflow_iso -= 1
            elif valid_iso:
                overflow_emb = 0
                while not stack[-1][2]:
                    stack.pop()
                stack.pop()
                valid_iso -= 1
            cur, override, _ = stack[-1]
            levels[i] = cur
            if override != "N":
                types[i] = override
        elif t == "PDF":                                           # X7
            removed[i] = True
            levels[i] = stack[-1][0]
            if overflow_iso:
                pass
            elif overflow_emb:
                overflow_emb -= 1
            elif not stack[-1][2] and len(stack) >= 2:
                stack.pop()
        elif t == "B":                                             # X8
            levels[i] = base_level
            stack = [(base_level, "N", False)]
            overflow_iso = overflow_emb = valid_iso = 0
        elif t == "BN":
            removed[i] = True
            levels[i] = stack[-1][0]
        else:                                                      # X6
            cur, override, _ = stack[-1]
            levels[i] = cur
            if override != "N":
                types[i] = override
    return levels, types, removed


def _isolating_run_sequences(idx: List[int], levels: List[int],
                             raw: List[str], base_level: int
                             ) -> List[Tuple[List[int], str, str]]:
    """X10: group level runs into isolating run sequences; compute sos/eos.

    ``idx`` is the X9-retained positions in logical order. Returns a list of
    (positions, sos, eos) with sos/eos in {"L", "R"}.
    """
    if not idx:
        return []
    # level runs over the retained subsequence
    runs: List[List[int]] = []
    for i in idx:
        if runs and levels[i] == levels[runs[-1][-1]]:
            runs[-1].append(i)
        else:
            runs.append([i])

    # BD9 matching over retained positions (isolates are never X9-removed)
    init_stack: List[int] = []
    pdi_of: dict = {}
    init_of: dict = {}
    for i in idx:
        if raw[i] in _ISOLATE_INIT:
            init_stack.append(i)
        elif raw[i] == "PDI" and init_stack:
            j = init_stack.pop()
            pdi_of[j] = i
            init_of[i] = j

    seqs: List[List[int]] = []
    seq_of_init: dict = {}
    for run in runs:
        first, last = run[0], run[-1]
        sid = None
        if raw[first] == "PDI" and first in init_of:
            sid = seq_of_init.get(init_of[first])
        if sid is None:
            seqs.append([])
            sid = len(seqs) - 1
        seqs[sid].extend(run)
        if raw[last] in _ISOLATE_INIT and last in pdi_of:
            seq_of_init[last] = sid

    pos_in_idx = {i: p for p, i in enumerate(idx)}
    out = []
    for seq in seqs:
        level = levels[seq[0]]
        p = pos_in_idx[seq[0]]
        prev_level = levels[idx[p - 1]] if p > 0 else base_level
        sos = "R" if max(level, prev_level) % 2 else "L"
        last = seq[-1]
        if raw[last] in _ISOLATE_INIT and last not in pdi_of:
            next_level = base_level  # unmatched initiator: eos vs paragraph
        else:
            q = pos_in_idx[last]
            next_level = levels[idx[q + 1]] if q + 1 < len(idx) else base_level
        eos = "R" if max(level, next_level) % 2 else "L"
        out.append((seq, sos, eos))
    return out


def _resolve_weak(types: List[str], sos: str) -> None:
    """W1-W7 in place. ``types`` uses raw UAX#9 classes."""
    n = len(types)

    # W1: NSM takes the type of the previous character (sos -> ON)
    prev = sos
    for i in range(n):
        if types[i] == "NSM":
            types[i] = prev if prev not in ("NSM",) else "ON"
        prev = types[i]

    # W2: EN -> AN when the last strong type before it is AL
    strong = sos
    for i in range(n):
        t = types[i]
        if t in ("L", "R", "AL"):
            strong = t
        elif t == "EN" and strong == "AL":
            types[i] = "AN"

    # W3: AL -> R
    for i in range(n):
        if types[i] == "AL":
            types[i] = "R"

    # W4: single ES between EN/EN -> EN; single CS between same numbers -> that
    for i in range(1, n - 1):
        if types[i] == "ES" and types[i - 1] == "EN" and types[i + 1] == "EN":
            types[i] = "EN"
        elif types[i] == "CS" and types[i - 1] == types[i + 1] and \
                types[i - 1] in ("EN", "AN"):
            types[i] = types[i - 1]

    # W5: runs of ET adjacent to EN -> EN
    i = 0
    while i < n:
        if types[i] == "ET":
            j = i
            while j < n and types[j] == "ET":
                j += 1
            before = types[i - 1] if i > 0 else sos
            after = types[j] if j < n else "ON"
            if before == "EN" or after == "EN":
                for k in range(i, j):
                    types[k] = "EN"
            i = j
        else:
            i += 1

    # W6: remaining separators/terminators -> ON
    for i in range(n):
        if types[i] in ("ET", "ES", "CS"):
            types[i] = "ON"

    # W7: EN -> L when the last strong type before it is L
    strong = sos
    for i in range(n):
        t = types[i]
        if t in ("L", "R"):
            strong = t
        elif t == "EN" and strong == "L":
            types[i] = "L"


def _pair_brackets(chars: List[str], types: List[str]) -> List[Tuple[int, int]]:
    """BD16: stack-based bracket pairing over ON characters."""
    stack: List[Tuple[str, int]] = []
    pairs: List[Tuple[int, int]] = []
    for i, (ch, t) in enumerate(zip(chars, types)):
        if t != "ON":
            continue
        if ch in _BRACKETS:
            if len(stack) < 63:
                stack.append((_BRACKETS[ch], i))
        elif ch in _BRACKETS_CLOSE:
            for s in range(len(stack) - 1, -1, -1):
                if stack[s][0] == ch:
                    pairs.append((stack[s][1], i))
                    del stack[s:]
                    break
    return sorted(pairs)


def _resolve_brackets(chars, types, pairs, e_dir, sos, orig):
    """N0: set matched bracket pairs to a strong direction from context.

    ``e_dir`` is the embedding direction of the run sequence (level parity),
    ``sos`` its start-of-sequence type, ``orig`` the pre-W1 raw classes
    (needed for the trailing-NSM adjustment)."""
    o_dir = "R" if e_dir == "L" else "L"

    def strong_of(t):
        if t in ("R", "EN", "AN"):
            return "R"
        if t == "L":
            return "L"
        return None

    def set_pair(open_i, close_i, d):
        types[open_i] = types[close_i] = d
        # N0 trailing-NSM rule: NSMs (by original class) immediately after
        # either bracket take the bracket's new resolved type.
        for b in (open_i, close_i):
            for k in range(b + 1, len(types)):
                if orig[k] == "NSM":
                    types[k] = d
                else:
                    break

    for open_i, close_i in pairs:
        inside = None
        found_opposite = False
        for k in range(open_i + 1, close_i):
            s = strong_of(types[k])
            if s == e_dir:
                inside = e_dir
                break
            if s == o_dir:
                found_opposite = True
        if inside == e_dir:
            set_pair(open_i, close_i, e_dir)
        elif found_opposite:
            # preceding context: first strong before the opening bracket
            context = sos
            for k in range(open_i - 1, -1, -1):
                s = strong_of(types[k])
                if s is not None:
                    context = s
                    break
            set_pair(open_i, close_i, o_dir if context == o_dir else e_dir)
        # else: no strong inside -> leave for N1/N2


def _resolve_neutrals(types: List[str], e_dir: str, sos: str, eos: str) -> None:
    """N1/N2; EN/AN act as R on both sides; sos/eos at the boundaries."""
    n = len(types)

    def as_strong(t: str) -> Optional[str]:
        if t in ("R", "EN", "AN"):
            return "R"
        if t == "L":
            return "L"
        return None

    neutral = ("B", "S", "WS", "ON")
    i = 0
    while i < n:
        if types[i] in neutral:
            j = i
            while j < n and types[j] in neutral:
                j += 1
            before = as_strong(types[i - 1]) if i > 0 else sos
            after = as_strong(types[j]) if j < n else eos
            fill = before if (before == after and before is not None) else e_dir
            for k in range(i, j):
                types[k] = fill
            i = j
        else:
            i += 1


def resolve_levels(text: str, base: Optional[str] = None) -> Tuple[List[int], List[str]]:
    """Run the full bidi algorithm; returns (levels, raw classes).

    X9-removed characters (LRE/RLE/LRO/RLO/PDF/BN) get level -1: dropping
    them before L2 is equivalent to UAX#9 §5.2's "level of the preceding
    character" retention recipe, so they can never change the visible order.
    Isolate initiators, PDI, and the LRM/RLM/ALM marks keep their RESOLVED
    levels — they participate in L2 run reversal as zero-width characters
    (their levels can legitimately split an otherwise-contiguous reversal
    run) and must only be dropped from the final visual string."""
    chars = list(text)
    raw = [_cls(c) for c in chars]
    if base is None:
        base = base_direction(text)
    base_level = 1 if base == "rtl" else 0

    # X1-X8 explicit levels/overrides; X9 removal mask
    levels, otypes, removed = _explicit_pass(raw, base_level)
    idx = [i for i in range(len(chars)) if not removed[i]]

    # X10: resolve each isolating run sequence with its own sos/eos
    for seq, sos, eos in _isolating_run_sequences(idx, levels, raw, base_level):
        seq_level = levels[seq[0]]
        e_dir = "R" if seq_level % 2 else "L"
        # isolate initiators/PDI participate as neutral ON in W/N rules
        types = [("ON" if raw[i] in ("PDI",) + _ISOLATE_INIT else otypes[i])
                 for i in seq]
        orig = [raw[i] for i in seq]
        wchars = [chars[i] for i in seq]

        _resolve_weak(types, sos)
        pairs = _pair_brackets(wchars, types)
        _resolve_brackets(wchars, types, pairs, e_dir, sos, orig)
        _resolve_neutrals(types, e_dir, sos, eos)

        # I1/I2: implicit level deltas relative to the sequence level
        for i, t in zip(seq, types):
            if seq_level % 2 == 0:
                levels[i] = seq_level + {"R": 1, "AN": 2, "EN": 2}.get(t, 0)
            else:
                levels[i] = seq_level + {"L": 1, "AN": 1, "EN": 1}.get(t, 0)

    # L1: S/B reset to base; trailing WS/isolate-formatting runs (by ORIGINAL
    # class) before S/B or at end of text reset to base.
    at_reset = True
    for p in range(len(idx) - 1, -1, -1):
        i = idx[p]
        t = raw[i]
        if t in ("S", "B"):
            levels[i] = base_level
            at_reset = True
        elif t in ("WS", "PDI") + _ISOLATE_INIT:
            if at_reset:
                levels[i] = base_level
        else:
            at_reset = False

    for i in range(len(chars)):
        if removed[i]:
            levels[i] = -1  # X9-removed: safe to drop pre-L2 (see docstring)
    return levels, raw


def reorder_visual(text: str, base: Optional[str] = None) -> str:
    """Logical -> visual order for an LTR renderer (L2 + L4 + mark removal)."""
    if not text:
        return text
    levels, _raw = resolve_levels(text, base)
    chars = list(text)

    # L4: mirror glyphs at odd levels before reversal
    chars = [
        _MIRROR_PAIRS.get(c, c) if lv >= 0 and lv % 2 else c
        for c, lv in zip(chars, levels)
    ]

    # Drop X9-removed characters; zero-width marks/isolates/PDI stay for L2
    # (their resolved levels can split reversal runs — see resolve_levels).
    kept = [(c, lv) for c, lv in zip(chars, levels) if lv >= 0]
    if not kept:
        return ""
    chars = [c for c, _ in kept]
    lvls = [lv for _, lv in kept]

    # L2: reverse maximal runs from the highest level down to 1
    n = len(chars)
    for level in range(max(lvls), 0, -1):
        i = 0
        while i < n:
            if lvls[i] >= level:
                j = i
                while j < n and lvls[j] >= level:
                    j += 1
                chars[i:j] = chars[i:j][::-1]
                lvls[i:j] = lvls[i:j][::-1]
                i = j
            else:
                i += 1
    # zero-width formatting characters are never drawn
    return "".join(c for c in chars if ord(c) not in _REMOVED)
