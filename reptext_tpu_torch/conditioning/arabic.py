"""Arabic text shaping (contextual joining) and bidi visual reordering.

The reference renders text with plain ``PIL.ImageDraw.draw.text`` (reference:
RepText/infer.py:74-76), which produces broken Arabic (isolated glyph forms,
left-to-right order) unless Pillow was built with libraqm. Proper shaping is a
first-class feature of this framework (SURVEY.md §2.1 "Arabic caveat"); neither
``arabic_reshaper`` nor ``python-bidi`` is vendored here, so both are
implemented from scratch:

- :func:`shape_arabic`: Unicode contextual analysis — selects isolated/final/
  initial/medial presentation forms (Arabic Presentation Forms-A/B) including
  lam-alef ligatures and join-transparent diacritics.
- :func:`bidi_reorder`: UAX#9 visual reordering (full weak-type W1-W7 with
  separate EN/AN, bracket pairs, directional marks) — see
  reptext_tpu_torch/conditioning/bidi.py, validated against GNU FriBidi fixtures.
- :func:`prepare_display_text`: shape then reorder, ready for LTR glyph
  rendering engines.
"""

from __future__ import annotations

from typing import List, Optional

# ---------------------------------------------------------------------------
# Contextual shaping tables
# ---------------------------------------------------------------------------

# base char -> (isolated, final, initial, medial); initial/medial None for
# right-joining letters (which only connect to the preceding letter).
_FORMS = {
    0x0621: (0xFE80, None, None, None),      # HAMZA
    0x0622: (0xFE81, 0xFE82, None, None),    # ALEF WITH MADDA
    0x0623: (0xFE83, 0xFE84, None, None),    # ALEF WITH HAMZA ABOVE
    0x0624: (0xFE85, 0xFE86, None, None),    # WAW WITH HAMZA
    0x0625: (0xFE87, 0xFE88, None, None),    # ALEF WITH HAMZA BELOW
    0x0626: (0xFE89, 0xFE8A, 0xFE8B, 0xFE8C),  # YEH WITH HAMZA
    0x0627: (0xFE8D, 0xFE8E, None, None),    # ALEF
    0x0628: (0xFE8F, 0xFE90, 0xFE91, 0xFE92),  # BEH
    0x0629: (0xFE93, 0xFE94, None, None),    # TEH MARBUTA
    0x062A: (0xFE95, 0xFE96, 0xFE97, 0xFE98),  # TEH
    0x062B: (0xFE99, 0xFE9A, 0xFE9B, 0xFE9C),  # THEH
    0x062C: (0xFE9D, 0xFE9E, 0xFE9F, 0xFEA0),  # JEEM
    0x062D: (0xFEA1, 0xFEA2, 0xFEA3, 0xFEA4),  # HAH
    0x062E: (0xFEA5, 0xFEA6, 0xFEA7, 0xFEA8),  # KHAH
    0x062F: (0xFEA9, 0xFEAA, None, None),    # DAL
    0x0630: (0xFEAB, 0xFEAC, None, None),    # THAL
    0x0631: (0xFEAD, 0xFEAE, None, None),    # REH
    0x0632: (0xFEAF, 0xFEB0, None, None),    # ZAIN
    0x0633: (0xFEB1, 0xFEB2, 0xFEB3, 0xFEB4),  # SEEN
    0x0634: (0xFEB5, 0xFEB6, 0xFEB7, 0xFEB8),  # SHEEN
    0x0635: (0xFEB9, 0xFEBA, 0xFEBB, 0xFEBC),  # SAD
    0x0636: (0xFEBD, 0xFEBE, 0xFEBF, 0xFEC0),  # DAD
    0x0637: (0xFEC1, 0xFEC2, 0xFEC3, 0xFEC4),  # TAH
    0x0638: (0xFEC5, 0xFEC6, 0xFEC7, 0xFEC8),  # ZAH
    0x0639: (0xFEC9, 0xFECA, 0xFECB, 0xFECC),  # AIN
    0x063A: (0xFECD, 0xFECE, 0xFECF, 0xFED0),  # GHAIN
    0x0640: (0x0640, 0x0640, 0x0640, 0x0640),  # TATWEEL (joins both ways)
    0x0641: (0xFED1, 0xFED2, 0xFED3, 0xFED4),  # FEH
    0x0642: (0xFED5, 0xFED6, 0xFED7, 0xFED8),  # QAF
    0x0643: (0xFED9, 0xFEDA, 0xFEDB, 0xFEDC),  # KAF
    0x0644: (0xFEDD, 0xFEDE, 0xFEDF, 0xFEE0),  # LAM
    0x0645: (0xFEE1, 0xFEE2, 0xFEE3, 0xFEE4),  # MEEM
    0x0646: (0xFEE5, 0xFEE6, 0xFEE7, 0xFEE8),  # NOON
    0x0647: (0xFEE9, 0xFEEA, 0xFEEB, 0xFEEC),  # HEH
    0x0648: (0xFEED, 0xFEEE, None, None),    # WAW
    0x0649: (0xFEEF, 0xFEF0, None, None),    # ALEF MAKSURA
    0x064A: (0xFEF1, 0xFEF2, 0xFEF3, 0xFEF4),  # YEH
    # Extended letters (Arabic block supplements for Persian, Urdu, Sindhi,
    # Pashto, Uyghur/Kazakh/Kirghiz), Presentation Forms-A FB50-FBFF. The
    # reference renders none of these correctly (raw draw.text,
    # RepText/infer.py:74-76); full coverage of every letter Unicode assigns
    # contextual forms to in that block:
    0x0671: (0xFB50, 0xFB51, None, None),    # ALEF WASLA
    0x0679: (0xFB66, 0xFB67, 0xFB68, 0xFB69),  # TTEH (Urdu)
    0x067A: (0xFB5E, 0xFB5F, 0xFB60, 0xFB61),  # TTEHEH
    0x067B: (0xFB52, 0xFB53, 0xFB54, 0xFB55),  # BEEH
    0x067E: (0xFB56, 0xFB57, 0xFB58, 0xFB59),  # PEH (Persian)
    0x067F: (0xFB62, 0xFB63, 0xFB64, 0xFB65),  # TEHEH
    0x0680: (0xFB5A, 0xFB5B, 0xFB5C, 0xFB5D),  # BEHEH
    0x0683: (0xFB76, 0xFB77, 0xFB78, 0xFB79),  # NYEH
    0x0684: (0xFB72, 0xFB73, 0xFB74, 0xFB75),  # DYEH
    0x0686: (0xFB7A, 0xFB7B, 0xFB7C, 0xFB7D),  # TCHEH (Persian)
    0x0687: (0xFB7E, 0xFB7F, 0xFB80, 0xFB81),  # TCHEHEH
    0x0688: (0xFB88, 0xFB89, None, None),    # DDAL (Urdu)
    0x068C: (0xFB84, 0xFB85, None, None),    # DAHAL
    0x068D: (0xFB82, 0xFB83, None, None),    # DDAHAL
    0x068E: (0xFB86, 0xFB87, None, None),    # DUL
    0x0691: (0xFB8C, 0xFB8D, None, None),    # RREH (Urdu)
    0x0698: (0xFB8A, 0xFB8B, None, None),    # JEH (Persian)
    0x06A4: (0xFB6A, 0xFB6B, 0xFB6C, 0xFB6D),  # VEH
    0x06A6: (0xFB6E, 0xFB6F, 0xFB70, 0xFB71),  # PEHEH
    0x06A9: (0xFB8E, 0xFB8F, 0xFB90, 0xFB91),  # KEHEH (Persian kaf)
    0x06AD: (0xFBD3, 0xFBD4, 0xFBD5, 0xFBD6),  # NG
    0x06AF: (0xFB92, 0xFB93, 0xFB94, 0xFB95),  # GAF (Persian)
    0x06B1: (0xFB9A, 0xFB9B, 0xFB9C, 0xFB9D),  # NGOEH
    0x06B3: (0xFB96, 0xFB97, 0xFB98, 0xFB99),  # GUEH
    0x06BA: (0xFB9E, 0xFB9F, None, None),    # NOON GHUNNA (Urdu)
    0x06BB: (0xFBA0, 0xFBA1, 0xFBA2, 0xFBA3),  # RNOON
    0x06BE: (0xFBAA, 0xFBAB, 0xFBAC, 0xFBAD),  # HEH DOACHASHMEE (Urdu)
    0x06C0: (0xFBA4, 0xFBA5, None, None),    # HEH WITH YEH ABOVE
    0x06C1: (0xFBA6, 0xFBA7, 0xFBA8, 0xFBA9),  # HEH GOAL (Urdu)
    0x06C5: (0xFBE0, 0xFBE1, None, None),    # KIRGHIZ OE
    0x06C6: (0xFBD9, 0xFBDA, None, None),    # OE
    0x06C7: (0xFBD7, 0xFBD8, None, None),    # U
    0x06C8: (0xFBDB, 0xFBDC, None, None),    # YU
    0x06C9: (0xFBE2, 0xFBE3, None, None),    # KIRGHIZ YU
    0x06CB: (0xFBDE, 0xFBDF, None, None),    # VE
    0x06CC: (0xFBFC, 0xFBFD, 0xFBFE, 0xFBFF),  # FARSI YEH
    0x06D0: (0xFBE4, 0xFBE5, 0xFBE6, 0xFBE7),  # E (Uyghur)
    0x06D2: (0xFBAE, 0xFBAF, None, None),    # YEH BARREE (Urdu)
    0x06D3: (0xFBB0, 0xFBB1, None, None),    # YEH BARREE WITH HAMZA
}

# LAM + alef-variant -> (isolated, final) ligature
_LAM_ALEF = {
    0x0622: (0xFEF5, 0xFEF6),
    0x0623: (0xFEF7, 0xFEF8),
    0x0625: (0xFEF9, 0xFEFA),
    0x0627: (0xFEFB, 0xFEFC),
}

_LAM = 0x0644

# Join-transparent marks: harakat, quranic annotation, superscript alef
_TRANSPARENT_RANGES = (
    (0x0610, 0x061A),
    (0x064B, 0x065F),
    (0x0670, 0x0670),
    (0x06D6, 0x06DC),
    (0x06DF, 0x06E4),
    (0x06E7, 0x06E8),
    (0x06EA, 0x06ED),
)

ISOLATED, FINAL, INITIAL, MEDIAL = 0, 1, 2, 3


def _is_transparent(cp: int) -> bool:
    return any(lo <= cp <= hi for lo, hi in _TRANSPARENT_RANGES)


def _joins_to_next(cp: int) -> bool:
    """Letter connects forward (has initial/medial forms)."""
    f = _FORMS.get(cp)
    return f is not None and f[INITIAL] is not None


def _joins_to_prev(cp: int) -> bool:
    """Letter connects backward (has a final form)."""
    f = _FORMS.get(cp)
    return f is not None and f[FINAL] is not None


def is_arabic_char(ch: str) -> bool:
    cp = ord(ch)
    return (
        0x0600 <= cp <= 0x06FF
        or 0x0750 <= cp <= 0x077F
        or 0x08A0 <= cp <= 0x08FF
        or 0xFB50 <= cp <= 0xFDFF
        or 0xFE70 <= cp <= 0xFEFF
    )


def contains_arabic(text: str) -> bool:
    return any(is_arabic_char(c) for c in text)


def shape_arabic(text: str) -> str:
    """Replace Arabic letters with contextual presentation forms (logical order).

    Handles dual- vs right-joining classes, join-transparent diacritics, and
    lam-alef ligatures. Non-Arabic characters pass through unchanged.
    """
    cps = [ord(c) for c in text]
    n = len(cps)

    def prev_joiner(i: int) -> Optional[int]:
        j = i - 1
        while j >= 0 and _is_transparent(cps[j]):
            j -= 1
        return cps[j] if j >= 0 else None

    def next_joiner(i: int) -> Optional[int]:
        j = i + 1
        while j < n and _is_transparent(cps[j]):
            j += 1
        return cps[j] if j < n else None

    out: List[str] = []
    i = 0
    while i < n:
        cp = cps[i]
        forms = _FORMS.get(cp)
        if forms is None:
            out.append(chr(cp))
            i += 1
            continue

        # Lam-alef ligature (direct adjacency modulo transparent marks)
        if cp == _LAM:
            nxt_idx = i + 1
            marks: List[int] = []
            while nxt_idx < n and _is_transparent(cps[nxt_idx]):
                marks.append(cps[nxt_idx])
                nxt_idx += 1
            if nxt_idx < n and cps[nxt_idx] in _LAM_ALEF:
                iso, fin = _LAM_ALEF[cps[nxt_idx]]
                prev = prev_joiner(i)
                lig = fin if (prev is not None and _joins_to_next(prev)) else iso
                out.append(chr(lig))
                out.extend(chr(m) for m in marks)
                i = nxt_idx + 1
                continue

        prev = prev_joiner(i)
        nxt = next_joiner(i)
        prev_conn = prev is not None and _joins_to_next(prev)
        next_conn = nxt is not None and _joins_to_prev(nxt)

        if prev_conn and next_conn and forms[MEDIAL] is not None:
            form = forms[MEDIAL]
        elif prev_conn and forms[FINAL] is not None:
            form = forms[FINAL]
        elif next_conn and forms[INITIAL] is not None:
            form = forms[INITIAL]
        else:
            form = forms[ISOLATED]
        out.append(chr(form))
        i += 1

    return "".join(out)


# ---------------------------------------------------------------------------
# Bidi: full UAX#9 core lives in reptext_tpu_torch.conditioning.bidi (separate
# EN/AN weak-type resolution, bracket pairs, LRM/RLM/ALM marks), pinned to
# GNU FriBidi golden fixtures. These aliases keep the original API.
# ---------------------------------------------------------------------------

from reptext_tpu_torch.conditioning.bidi import (  # noqa: E402
    base_direction,
    needs_bidi,
    reorder_visual,
)


def bidi_reorder(text: str, base: Optional[str] = None) -> str:
    """Logical order -> visual order for an LTR renderer (UAX#9)."""
    return reorder_visual(text, base)


def prepare_display_text(text: str) -> str:
    """Shape Arabic joining forms then reorder to visual order for LTR drawing.

    This is what the frontend feeds to ``PIL.ImageDraw.text``; for plain LTR
    text (no RTL characters AND no directional formatting characters) it is
    the identity. Text with directional marks/embeddings/isolates goes
    through the bidi pass even when it has no Arabic, both to apply the
    explicit codes (X1-X8) and to strip the zero-width characters the
    renderer must never draw.
    """
    if not needs_bidi(text):
        return text
    return bidi_reorder(shape_arabic(text))
