"""Pure-Python SMILES syntax check (copy of ``spmm_tpu.chem.smiles``).

The fallback of ``chem.featurizer.canonicalize`` when RDKit is unavailable:
a syntactic validity check over the OpenSMILES grammar (organic-subset and
bracket atoms, bond symbols, branches, ring-bond pairing including %nn, and
dot-separated components).  It does NOT perceive aromaticity or check
valence.
"""

from __future__ import annotations

import re

ORGANIC_ATOMS = ("Br", "Cl", "B", "C", "N", "O", "P", "S", "F", "I",
                 "b", "c", "n", "o", "p", "s")
BOND_CHARS = set("-=#$:/\\")

_BRACKET_RE = re.compile(
    r"^\[(?P<isotope>\d+)?"
    r"(?P<symbol>[A-Z][a-z]?|[a-z]{1,2}|\*)"
    r"(?P<chiral>@{1,2}(?:TH[12]|AL[12]|SP[1-3]|TB\d{1,2}|OH\d{1,2})?)?"
    r"(?P<hcount>H\d*)?"
    r"(?P<charge>\+{1,3}|-{1,3}|\+\d+|-\d+)?"
    r"(?::(?P<map>\d+))?\]$"
)


def _match_atom(s: str, i: int) -> int:
    """Return new index after an atom at s[i:], or -1 if none."""
    if s[i] == "[":
        j = s.find("]", i)
        if j == -1:
            return -1
        if not _BRACKET_RE.match(s[i: j + 1]):
            return -1
        return j + 1
    for a in ORGANIC_ATOMS:
        if s.startswith(a, i):
            return i + len(a)
    if s[i] == "*":
        return i + 1
    return -1


def is_valid_syntax(smiles: str) -> bool:
    """Syntactic SMILES validity (no valence/aromaticity checks)."""
    if not smiles or smiles != smiles.strip():
        return False
    s = smiles
    i, n = 0, len(s)
    depth = 0
    open_rings: dict[str, None] = {}
    prev_atom = False          # an atom has been read in the current chain
    pending_bond = False       # a bond symbol awaits an atom/ring closure
    fresh_branch = False       # just after '(' — an atom (or bond) must follow

    while i < n:
        c = s[i]
        if c == "(":
            if not prev_atom or fresh_branch:
                return False
            depth += 1
            pending_bond = False
            fresh_branch = True
            i += 1
            continue
        if c == ")":
            if depth == 0 or pending_bond or fresh_branch:
                return False
            depth -= 1
            i += 1
            continue
        if c == ".":
            if pending_bond or not prev_atom or depth != 0:
                return False
            prev_atom = False
            i += 1
            continue
        if c in BOND_CHARS:
            if not prev_atom or pending_bond:
                return False
            pending_bond = True
            i += 1
            continue
        if c.isdigit() or c == "%":
            if not prev_atom or fresh_branch:
                return False
            if c == "%":
                if i + 2 >= n or not (s[i + 1].isdigit() and s[i + 2].isdigit()):
                    return False
                ring = s[i: i + 3]
                i += 3
            else:
                ring = c
                i += 1
            if ring in open_rings:
                del open_rings[ring]
            else:
                open_rings[ring] = None
            pending_bond = False
            continue
        j = _match_atom(s, i)
        if j == -1:
            return False
        prev_atom = True
        pending_bond = False
        fresh_branch = False
        i = j

    return depth == 0 and not open_rings and not pending_bond and prev_atom
