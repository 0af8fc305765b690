# Frozen copy of homerhevc_tpu_torch/hevc/ctx_tables.py, lines 1-139, for the
# benchmark's plain reference decoder: later changes to the program
# do not move it. Imports point at the other copies beside it.
"""CABAC context model layout and initialization values.

Init values are H.265 spec constants (Tables 9-5..9-32; also HM / reference
hmr_ctx_tables.h). Row order of each 3-row table: [B, P, I] slice (HM
convention; maps to spec initType 2/1/0).

The models live in one flat uint8 array (state byte = (pStateIdx<<1)|valMPS),
with named offsets — this makes WPP context forking (reference
ee_copy_entropy_model, hmr_encoder_lib.c:2371) a single array copy and keeps
the C++ production coder's layout identical to the Python reference coder.
"""

from __future__ import annotations

import numpy as np

CNU = 154

# fmt: off
INIT_CU_TRANSQUANT_BYPASS = [[154], [154], [154]]
INIT_SPLIT_FLAG = [[107, 139, 126], [107, 139, 126], [139, 141, 157]]
INIT_SKIP_FLAG = [[197, 185, 201], [197, 185, 201], [CNU, CNU, CNU]]
INIT_MERGE_FLAG = [[154], [110], [CNU]]
INIT_MERGE_IDX = [[137], [122], [CNU]]
INIT_PART_SIZE = [[154, 139, 154, 154], [154, 139, 154, 154], [184, CNU, CNU, CNU]]
INIT_PRED_MODE = [[134], [149], [CNU]]
INIT_INTRA_PRED_MODE = [[183], [154], [184]]
INIT_CHROMA_PRED_MODE = [[152, 139], [152, 139], [63, 139]]
INIT_INTER_DIR = [[95, 79, 63, 31, 31], [95, 79, 63, 31, 31], [CNU] * 5]
INIT_MVD = [[169, 198], [140, 198], [CNU, CNU]]
INIT_REF_PIC = [[153, 153], [153, 153], [CNU, CNU]]
INIT_DQP = [[154, 154, 154]] * 3
INIT_QT_CBF = [
    [153, 111, CNU, CNU, 149, 92, 167, 154],
    [153, 111, CNU, CNU, 149, 107, 167, 154],
    [111, 141, CNU, CNU, 94, 138, 182, 154],
]
INIT_QT_ROOT_CBF = [[79], [79], [CNU]]
INIT_LAST = [
    [125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111, 111, 79,
     108, 123, 93] + [CNU] * 12,
    [125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95, 94,
     108, 123, 108] + [CNU] * 12,
    [110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127, 111, 79,
     108, 123, 63] + [CNU] * 12,
]
INIT_SIG_CG = [[121, 140, 61, 154], [121, 140, 61, 154], [91, 171, 134, 141]]
INIT_SIG = [
    [170, 154, 139, 153, 139, 123, 123, 63, 124, 166, 183, 140, 136, 153, 154,
     166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 170, 153, 138,
     138, 122, 121, 122, 121, 167, 151, 183, 140, 151, 183, 140],
    [155, 154, 139, 153, 139, 123, 123, 63, 153, 166, 183, 140, 136, 153, 154,
     166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 170, 153, 123,
     123, 107, 121, 107, 121, 167, 151, 183, 140, 151, 183, 140],
    [111, 111, 125, 110, 110, 94, 124, 108, 124, 107, 125, 141, 179, 153, 125,
     107, 125, 141, 179, 153, 125, 107, 125, 141, 179, 153, 125, 140, 139, 182,
     182, 152, 136, 152, 136, 153, 136, 139, 111, 136, 139, 111],
]
INIT_ONE = [
    [154, 196, 167, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121, 136,
     122, 169, 208, 166, 167, 154, 152, 167, 182],
    [154, 196, 196, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121, 136,
     137, 169, 194, 166, 167, 154, 167, 137, 182],
    [140, 92, 137, 138, 140, 152, 138, 139, 153, 74, 149, 92, 139, 107, 122,
     152, 140, 179, 166, 182, 140, 227, 122, 197],
]
INIT_ABS = [
    [107, 167, 91, 107, 107, 167],
    [107, 167, 91, 122, 107, 167],
    [138, 153, 136, 167, 152, 152],
]
INIT_MVP_IDX = [[168], [168], [CNU]]
INIT_SAO_MERGE = [[153], [153], [153]]
INIT_SAO_TYPE = [[160], [185], [200]]
INIT_TRANS_SUBDIV = [[224, 167, 122], [124, 138, 94], [153, 138, 138]]
INIT_TRANSFORM_SKIP = [[139, 139], [139, 139], [139, 139]]
# fmt: on

# (name, count, init_table) in layout order
_LAYOUT = [
    ("split_flag", 3, INIT_SPLIT_FLAG),
    ("skip_flag", 3, INIT_SKIP_FLAG),
    ("merge_flag", 1, INIT_MERGE_FLAG),
    ("merge_idx", 1, INIT_MERGE_IDX),
    ("part_size", 4, INIT_PART_SIZE),
    ("pred_mode", 1, INIT_PRED_MODE),
    ("intra_pred_mode", 1, INIT_INTRA_PRED_MODE),
    ("chroma_pred_mode", 2, INIT_CHROMA_PRED_MODE),
    ("inter_dir", 5, INIT_INTER_DIR),
    ("mvd", 2, INIT_MVD),
    ("ref_pic", 2, INIT_REF_PIC),
    ("dqp", 3, INIT_DQP),
    ("qt_cbf", 8, INIT_QT_CBF),          # luma ctx 0..3 (2 used), chroma 4..7
    ("qt_root_cbf", 1, INIT_QT_ROOT_CBF),
    ("sig_cg", 4, INIT_SIG_CG),          # luma 0..1, chroma 2..3
    ("sig", 42, INIT_SIG),               # luma 0..26, chroma 27..41
    ("last_x", 30, INIT_LAST),           # luma 0..14, chroma 15..29
    ("last_y", 30, INIT_LAST),
    ("one", 24, INIT_ONE),               # luma 0..15, chroma 16..23
    ("abs", 6, INIT_ABS),                # luma 0..3, chroma 4..5
    ("mvp_idx", 1, INIT_MVP_IDX),
    ("trans_subdiv", 3, INIT_TRANS_SUBDIV),
    ("transform_skip", 2, INIT_TRANSFORM_SKIP),
    ("transquant_bypass", 1, INIT_CU_TRANSQUANT_BYPASS),
    ("sao_merge", 1, INIT_SAO_MERGE),
    ("sao_type", 1, INIT_SAO_TYPE),
]

OFF = {}
_off = 0
for _name, _cnt, _ in _LAYOUT:
    OFF[_name] = _off
    _off += _cnt
NUM_CTX = _off

_SLICE_ROW = {"B": 0, "P": 1, "I": 2}


def _init_state(init_value: int, qp: int) -> int:
    """Spec 9.3.2.2: initValue -> (pStateIdx<<1)|valMps packed state byte."""
    slope = (init_value >> 4) * 5 - 45
    offset = ((init_value & 15) << 3) - 16
    pre = min(max(1, ((slope * min(max(0, qp), 51)) >> 4) + offset), 126)
    if pre <= 63:
        return ((63 - pre) << 1) | 0
    return ((pre - 64) << 1) | 1


def init_contexts(slice_type: str, qp: int) -> np.ndarray:
    """Fresh context state array for a slice."""
    row = _SLICE_ROW[slice_type]
    states = np.zeros(NUM_CTX, np.uint8)
    for name, cnt, table in _LAYOUT:
        vals = table[row]
        assert len(vals) == cnt, name
        base = OFF[name]
        for i, iv in enumerate(vals):
            states[base + i] = _init_state(iv, qp)
    return states
