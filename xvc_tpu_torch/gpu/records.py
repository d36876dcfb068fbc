"""Column layout of the native parse's record table.

One int32 row per CU node of either tree (``native/pic.py``
``parse_picture``, ``xvcn_pic.inc`` ``xvcn_export_parse``; the rows are
``PARSE_REC_STRIDE`` wide).  The flat reconstruction (``flat_recon.py``)
and the picture kernels (``itx.itx_picture``, ``mc.mc_picture``, and
their CUDA twins in ``kernels/csrc/records.cuh``) read it.
"""
C_TREE, C_DEPTH, C_X, C_Y, C_W, C_H, C_SPLIT = range(7)
C_PRED, C_QP, C_SKIP, C_MERGE, C_MERGEIDX, C_DIR, C_FULLPEL, C_AFFINE, \
    C_LIC, C_ROOTCBF = 11, 12, 13, 14, 15, 16, 17, 18, 19, 20
C_CBF0, C_TSKIP0, C_DCONLY0 = 21, 24, 27
C_TT00, C_TT01, C_TT10, C_TT11, C_TXSEL = 30, 31, 32, 33, 34
C_REF0, C_REF1, C_IML, C_IMC = 35, 36, 39, 40
C_MV = 41            # [list][corner][x/y]: 41 + 8*l + 2*c (+1 for y)
C_COEFF0 = 65
C_SBL, C_SAR, C_ORDER = 68, 69, 70
MIN_COLS = 71        # the columns the readers need
