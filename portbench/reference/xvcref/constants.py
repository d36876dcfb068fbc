"""Normative constants of the xvc bitstream format.

TPU-native reimplementation of the constant set defined by the reference
codec (ref: src/xvc_common_lib/common.h:74-158).  These values are facts of
the bitstream format and must match exactly for interoperability.
"""
from enum import IntEnum

# Codec identification (common.h:77-80)
XVC_CODEC_IDENTIFIER = 7894627
XVC_MAJOR_VERSION = 2
XVC_MINOR_VERSION = 0
SUPPORTED_OLD_VERSIONS = ((1, 0),)

# Picture limits
MAX_YUV_COMPONENTS = 3
MAX_NUM_PLANES = 2
MAX_NUM_CU_TREES = 2

# CU limits (common.h:88-108)
CTU_SIZE_LOG2 = 6
CTU_SIZE = 1 << CTU_SIZE_LOG2
MAX_CU_DEPTH = 3
MAX_CU_DEPTH_CHROMA = MAX_CU_DEPTH + 1
MIN_CU_SIZE = CTU_SIZE >> MAX_CU_DEPTH  # 8
MAX_BINARY_SPLIT_DEPTH = 3
MAX_BINARY_SPLIT_SIZE_INTER = CTU_SIZE
MAX_BINARY_SPLIT_SIZE_INTRA1 = 32
MAX_BINARY_SPLIT_SIZE_INTRA2 = 16
MIN_BINARY_SPLIT_SIZE = 4
MAX_BLOCK_SIZE = CTU_SIZE
MIN_BLOCK_SIZE = 4
MAX_BLOCK_SAMPLES = MAX_BLOCK_SIZE * MAX_BLOCK_SIZE
QUAD_SPLIT = 4

# Transform (common.h:113-116)
TRANSFORM_SKIP_MAX_AREA = 4 * 4
TRANSFORM_SELECT_MIN_SIG_COEFFS = 3
TRANSFORM_ZERO_OUT_MIN_SIZE = 32
MAX_TRANSFORM_SELECT_IDX = 4

# Prediction (common.h:119-123)
NUM_INTRA_MPM = 3
NUM_INTRA_MPM_EXT = 6
NUM_INTER_MV_PREDICTORS = 2
NUM_INTER_MERGE_CANDIDATES = 5
TEMPORAL_MV_PREDICTION = True

# Quant (common.h:126-131)
MAX_TR_DYNAMIC_RANGE = 15
MIN_ALLOWED_QP = -64
MAX_ALLOWED_QP = 63
MAX_QP_DIFF = 16
QP_SIGNAL_BASE = 64
CHROMA_OFFSET_BITS = 6

# Residual coding (common.h:134-138)
MAX_NUM_C1_FLAGS = 8
MAX_NUM_C2_FLAGS = 1
SUBBLOCK_SHIFT = 2
COEFF_REMAIN_BIN_REDUCTION = 3
SIGN_HIDING_THRESHOLD = 3

# Deblocking
DEBLOCK_OFFSET_BITS = 6

MAX_NUM_REF_PICS = 5

# High-level syntax (common.h:147-152)
TIME_SCALE = 90000
MAX_TID = 8
FRAMERATE_BITDEPTH = 24
PIC_SIZE_BITS = 16
MAX_SUB_GOP_LENGTH = 64
ENCAPSULATION_CODE = 86

INT16_MAX = 32767
INT16_MIN = -32768


class ChromaFormat(IntEnum):
    MONOCHROME = 0
    YUV420 = 1
    YUV422 = 2
    YUV444 = 3
    ARGB = 4
    UNDEFINED = 255


class ColorMatrix(IntEnum):
    UNDEFINED = 0
    K601 = 1
    K709 = 2
    K2020 = 3


class NalUnitType(IntEnum):
    INTRA_PICTURE = 0
    INTRA_ACCESS_PICTURE = 1
    PREDICTED_PICTURE = 2
    PREDICTED_ACCESS_PICTURE = 3
    BIPREDICTED_PICTURE = 4
    BIPREDICTED_ACCESS_PICTURE = 5
    RESERVED_PICTURE_TYPE_10 = 10
    SEGMENT_HEADER = 16
    SEI = 17
    ACCESS_UNIT_DELIMITER = 18
    END_OF_SEGMENT = 19


class PicturePredictionType(IntEnum):
    BI = 0
    UNI = 1
    INTRA = 2


class DeblockingMode(IntEnum):
    DISABLED = 0
    ENABLED = 1
    PER_PICTURE = 2
    CUSTOM = 3


class ChecksumMode(IntEnum):
    MIN_OVERHEAD = 0
    MAX_ROBUST = 1


class ChecksumMethod(IntEnum):
    MD5 = 0
    CRC = 1


class SplitType(IntEnum):
    NONE = 0
    QUAD = 1
    HORIZONTAL = 2
    VERTICAL = 3


class SplitRestriction(IntEnum):
    NONE = 0
    NO_HORIZONTAL = 1
    NO_VERTICAL = 2


class PredictionMode(IntEnum):
    INTRA = 0
    INTER = 1


class TransformType(IntEnum):
    DEFAULT = 0
    DCT2 = 1
    DCT5 = 2
    DCT8 = 3
    DST1 = 4
    DST7 = 5


class ScanOrder(IntEnum):
    DIAGONAL = 0
    HORIZONTAL = 1
    VERTICAL = 2


class InterDir(IntEnum):
    L0 = 0
    L1 = 1
    BI = 2


class RefPicList(IntEnum):
    L0 = 0
    L1 = 1


# Intra modes: kPlanar=0, kDc=1, angular 2..34 (35-mode set) or 2..66 (ext)
INTRA_MODE_INVALID = -1
INTRA_MODE_LM_CHROMA = -2
INTRA_CHROMA_DM = -1
NBR_INTRA_MODES = 35
NBR_INTRA_MODES_EXT = 67


class IntraAngle(IntEnum):
    PLANAR = 0
    DC = 1
    FIRST = 2
    HORIZONTAL = 10
    DIAGONAL = 18
    VERTICAL = 26


class CuTree(IntEnum):
    PRIMARY = 0
    SECONDARY = 1


def num_components(chroma_format):
    return 1 if chroma_format == ChromaFormat.MONOCHROME else 3


def chroma_shift_x(chroma_format):
    if chroma_format in (ChromaFormat.YUV420, ChromaFormat.YUV422):
        return 1
    return 0


def chroma_shift_y(chroma_format):
    if chroma_format == ChromaFormat.YUV420:
        return 1
    return 0
