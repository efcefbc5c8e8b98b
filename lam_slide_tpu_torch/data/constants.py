"""Shared element/residue encoding tables (reference src/utils/constants.py),
copied from ``lam_slide_tpu/data/constants.py``.

Used by dataset featurizers (atom-type one-hots), the PDB tooling and the
3D figures (analysis/plots.py ties its colors to ELEMENT_COLORS). The
reference defines ``ATOM_COLOR_MAP`` twice (element symbols at
constants.py:23-32, atomic numbers at constants.py:79-90 — the later
shadows the earlier); both live here under distinct names.
"""

ATOM_ENCODING = {"C": 0, "N": 1, "O": 2, "S": 3, "H": 4}

ATOM_ENCODING_COLOR = {"C": "black", "N": "blue", "O": "red", "S": "yellow",
                       "H": "white"}

# element-symbol keyed (constants.py:23-32; '#' = unknown/other)
ELEMENT_COLORS = {"#": "orange", "H": "white", "C": "black", "N": "blue",
                  "O": "red", "S": "yellow"}

NUM_TO_ATOM_TYPE = {1: "H", 6: "C", 7: "N", 8: "O"}

# both 3-letter and 1-letter residue codes -> class index (constants.py:36-77)
AA_TO_NUM = {
    "ALA": 0, "A": 0, "ARG": 1, "R": 1, "ASN": 2, "N": 2, "ASP": 3, "D": 3,
    "CYS": 4, "C": 4, "GLN": 5, "Q": 5, "GLU": 6, "E": 6, "GLY": 7, "G": 7,
    "HIS": 8, "H": 8, "ILE": 9, "I": 9, "LEU": 10, "L": 10, "LYS": 11, "K": 11,
    "MET": 12, "M": 12, "PHE": 13, "F": 13, "PRO": 14, "P": 14, "SER": 15,
    "S": 15, "THR": 16, "T": 16, "TRP": 17, "W": 17, "TYR": 18, "Y": 18,
    "VAL": 19, "V": 19,
}

# atomic-number keyed display colors (constants.py:79-90)
ATOMIC_NUMBER_COLORS = {
    1: "white", 2: "#FFC0CB", 3: "#FF0000", 4: "#00FF00", 5: "#FFB200",
    6: "black", 7: "blue", 8: "red", 9: "#FFFF00", 10: "#FF1493",
}
