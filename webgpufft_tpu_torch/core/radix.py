"""Host side of the radix-chain FFT that K1 and K2 run inside a CTA.

Both CUDA kernels (``csrc/fused_lines.cu``, ``csrc/fused_cols.cu``, sharing
``csrc/radix.cuh``) compute a length-N DFT as a Stockham autosort chain of
in-register butterflies, N = r_0 * r_1 * ... * r_{P-1} with every r_p in
``KERNEL_RADICES`` (``factors.SUPPORTED_RADICES`` and 16).  Pass p, with ns = r_0 * ... * r_{p-1}
(ns = 1 for the first pass), R = r_p and m = N / R, does for every
j in [0, m):

    k      = j mod ns
    v[r]   = in[j + r * m]                      r = 0 .. R-1
    v[r]  *= W_N^(r * k * N / (ns * R))         r = 1 .. R-1 (none when ns = 1)
    v      = DFT_R(v)
    out[(j - k) * R + k + r * ns] = v[r]

and the last pass leaves natural order.  The twiddles of all passes are one
table of N - 1 roots of unity laid out in the order the passes read them
(``chain_twiddles``), so neighbouring threads read neighbouring entries.

This module builds what the kernels need beyond the plain versions' tables
(``chain_consts``: the twiddle table and a two-float parameter table
holding the scale and the direction's sign), chooses the chain
(``radix_chain``; K1's own rule ``lines_chain``), and models the pass
schedule on the CPU with the same index maps, tables and butterfly algebra
as the CUDA code (``radix_chain_reference``): a test aid that no plan path
calls.

K1 has seven designs (``csrc/fused_lines.cu``).  The lengths of
``POW2_LINES`` (256, 1024, 2048, 4096, 8192, 16384) run the power-of-two
design (``csrc/lines_pow2.cu``, a kernel per length, one line a CTA) on
three passes, the first of radix 32 at 8192 and 16384, 8 * 8 * 4 at 256;
the length of ``WARP_LINES`` (512) runs the warp design
(``csrc/lines_warp.cu``, a kernel per length, a line in the lanes of one
warp); the lengths of ``MIXED_LINES`` run the mixed-radix design
(``csrc/lines_mixed.cu``, a kernel per length, two to four passes of
radices up to 32, the composite ones, 6 to 30, each one butterfly in
registers: ``MIXED_RADICES``); the lengths of ``PACKED_LINES`` (128 points
or less) run the packed design (``csrc/lines_packed.cu``, a kernel per
length, a warp's lines landed in shared memory as one contiguous block and
run there, on ``radix_chain(n)``: ``packed_lines_reference`` models its
block-staged layout); the lengths of ``GENERAL_LINES`` run the general
mixed-radix design (``csrc/lines_general.cu``, one kernel a class of points
a thread for every chain of two to four passes of ``GENERAL_RADICES``, in
the fewest passes they allow: ``general_threads`` sizes its CTA); the
lengths of ``CLUSTER_LINES`` (from 11583) run the cluster design
(``csrc/cluster.cu``, shared with K2: the general design's passes on a line
split over a thread-block cluster, the first pass across it;
``cluster_plan`` sizes its CTA, ``cluster_chain_reference`` models its
schedule); every other length runs the direct design on
``radix_chain(n)``.  The C entry point holds the same tables
(``kPow2Lines``, ``kWarpLines``, ``kMixedLines``, ``kPackedLines``,
``kGeneralLines``, ``csrc/lines.cuh``; ``kClusterLines``,
``csrc/cluster.cuh``, which this module reads)
and refuses any other chain at those lengths, so K1's ``cw`` table is laid
out for ``lines_chain(n)``.  K2 runs ``radix_chain`` at
every height.
"""

from __future__ import annotations

import math
import re
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import factors

MAX_LENGTH = 16384   # 128 * 128: the longest line a CTA holds in shared memory
MAX_PASSES = 16      # room in the kernels' chain argument
TABLE_NAMES = ("cw", "cp")
# what the kernels have a butterfly for: the supported set and 16 = 4 * 4
KERNEL_RADICES = factors.SUPPORTED_RADICES + (16,)
# K1's rule: N -> the chain of the power-of-two design (csrc/lines_pow2.cu);
# the lengths where it ran fastest on the H100 (PERF.md): 1024, 2048 and
# 4096 on radix_chain's own chain (the same cw table), 8192 and 16384 in
# three passes where radix_chain takes four, 256 in three (8 * 8 * 4, 8
# points a thread) where radix_chain takes two
POW2_LINES = {256: (8, 8, 4), 1024: (16, 8, 8), 2048: (16, 16, 8), 4096: (16, 16, 16),
              8192: (32, 16, 16), 16384: (32, 32, 16)}
# and N -> the chain of the warp design (csrc/lines_warp.cu), where it ran
# fastest: 512, on radix_chain's own chain (32, its other length until the
# packed design, runs that design now)
WARP_LINES = {512: (8, 8, 8)}
# and N -> the chain of the mixed-radix design (csrc/lines_mixed.cu): the
# lengths that are not powers of two where its sweep on the H100 ran faster
# than the direct design (PERF.md), each in two to four passes where
# radix_chain takes three to five (1352 in radix_chain's own three)
MIXED_LINES = {360: (20, 18), 1000: (10, 10, 10), 1352: (13, 13, 8), 1536: (8, 8, 24),
               2079: (27, 7, 11), 2310: (22, 15, 7), 3000: (10, 10, 30), 3072: (32, 4, 24),
               5120: (16, 16, 20), 6000: (24, 25, 10), 6144: (32, 24, 8), 8232: (8, 21, 7, 7),
               9216: (32, 24, 12), 12288: (32, 32, 12), 15360: (32, 32, 15)}
# and N -> the chain of the packed design (csrc/lines_packed.cu): the short
# lengths where its sweep on the H100 ran faster than the direct design at
# both line counts (PERF.md), each on radix_chain's own chain (the same cw
# table)
PACKED_LINES = {4: (4,), 6: (3, 2), 8: (8,), 9: (3, 3), 10: (5, 2), 12: (4, 3), 14: (7, 2),
                15: (5, 3), 16: (16,), 18: (3, 3, 2), 20: (5, 4), 21: (7, 3), 22: (11, 2),
                24: (8, 3), 25: (5, 5), 26: (13, 2), 27: (3, 3, 3), 28: (7, 4), 30: (5, 3, 2),
                32: (8, 4), 33: (11, 3), 35: (7, 5), 36: (4, 3, 3), 39: (13, 3), 40: (8, 5),
                42: (7, 3, 2), 44: (11, 4), 45: (5, 3, 3), 48: (16, 3), 49: (7, 7),
                50: (5, 5, 2), 52: (13, 4), 54: (3, 3, 3, 2), 55: (11, 5), 56: (8, 7),
                60: (5, 4, 3), 63: (7, 3, 3), 64: (8, 8), 65: (13, 5), 66: (11, 3, 2),
                70: (7, 5, 2), 72: (8, 3, 3), 75: (5, 5, 3), 77: (11, 7), 78: (13, 3, 2),
                80: (16, 5), 81: (3, 3, 3, 3), 84: (7, 4, 3), 88: (11, 8), 90: (5, 3, 3, 2),
                91: (13, 7), 98: (7, 7, 2), 99: (11, 3, 3), 100: (5, 5, 4), 104: (13, 8),
                105: (7, 5, 3), 110: (11, 5, 2), 112: (16, 7), 117: (13, 3, 3), 121: (11, 11),
                125: (5, 5, 5), 126: (7, 3, 3, 2)}
# the composite radices the mixed-radix design has a butterfly for (R = A * B,
# lines_mixed.cuh), beside KERNEL_RADICES and 32
MIXED_RADICES = (6, 9, 10, 12, 14, 15, 18, 20, 21, 22, 24, 25, 26, 27, 28, 30)
# every radix of the mixed-radix and the general designs: up to 32, primes
# 2 .. 13
GENERAL_RADICES = tuple(sorted(set(KERNEL_RADICES + MIXED_RADICES + (32,))))
# the general design's classes (csrc/lines_general.cuh least_radix,
# max_threads): the most points a thread holds -> (the least radix it
# takes, the most threads a CTA)
GENERAL_CLASSES = {16: (2, 768), 20: (4, 704), 24: (4, 640), 32: (5, 512), 64: (16, 352)}


class GeneralLine(NamedTuple):
    """A length's entry in the general design's table."""
    points: int               # the most points a thread holds: the kernel's class
    lines: int                # a CTA
    chain: Tuple[int, ...]


# and N -> (points, lines a CTA, chain) of the general mixed-radix design
# (csrc/lines_general.cu, one kernel a class for every chain of two to four
# passes of GENERAL_RADICES): the lengths where its sweep on the H100 beat
# the direct design at both line counts, each in the fewest passes those
# radices allow, in the order, class and lines a CTA that won
# (chip_probes/k1_general_variants.py --fit writes this table and
# WGFFT_GENERAL_LINES of csrc/lines.cuh from the sweep)
_GENERAL = (
    (96, 20, 21, 12, 8), (108, 16, 18, 9, 12), (120, 16, 17, 10, 12), (128, 16, 16, 16, 8),
    (130, 16, 15, 10, 13), (132, 20, 15, 12, 11), (135, 16, 15, 9, 15), (140, 16, 14, 10, 14),
    (143, 20, 14, 13, 11), (144, 20, 14, 12, 12), (147, 24, 13, 21, 7), (150, 16, 13, 10, 15),
    (154, 20, 13, 14, 11), (156, 16, 13, 12, 13), (160, 16, 12, 16, 10), (162, 20, 12, 18, 9),
    (165, 20, 12, 15, 11), (168, 20, 12, 14, 12), (169, 16, 12, 13, 13), (175, 32, 11, 25, 7),
    (176, 20, 11, 16, 11), (180, 16, 11, 12, 15), (182, 24, 11, 14, 13), (189, 24, 10, 21, 9),
    (192, 20, 10, 16, 12), (195, 24, 10, 15, 13), (196, 24, 10, 14, 14), (198, 20, 10, 18, 11),
    (200, 20, 10, 20, 10), (208, 20, 9, 16, 13), (210, 24, 9, 15, 14), (216, 20, 9, 12, 18),
    (220, 20, 9, 20, 11), (224, 24, 9, 16, 14), (225, 24, 9, 15, 15), (231, 24, 8, 21, 11),
    (234, 20, 8, 18, 13), (240, 20, 8, 16, 15), (242, 24, 8, 22, 11), (243, 32, 8, 27, 9),
    (245, 20, 8, 7, 7, 5), (250, 32, 8, 25, 10), (252, 20, 8, 18, 14), (260, 20, 7, 20, 13),
    (264, 32, 7, 22, 12), (270, 20, 7, 15, 18), (273, 24, 7, 13, 21), (275, 32, 7, 25, 11),
    (280, 20, 7, 20, 14), (286, 24, 7, 13, 22), (288, 20, 7, 16, 18), (294, 24, 6, 14, 21),
    (297, 32, 6, 27, 11), (300, 20, 6, 15, 20), (308, 24, 6, 14, 22), (312, 24, 6, 24, 13),
    (315, 24, 6, 15, 21), (320, 20, 6, 16, 20), (324, 24, 6, 18, 18), (325, 32, 6, 25, 13),
    (330, 24, 6, 15, 22), (336, 24, 6, 16, 21), (338, 32, 6, 26, 13), (343, 20, 5, 7, 7, 7),
    (350, 32, 11, 25, 14), (351, 32, 5, 27, 13), (352, 24, 5, 16, 22), (363, 16, 5, 11, 11, 3),
    (364, 32, 5, 14, 26), (375, 32, 10, 25, 15), (378, 24, 5, 18, 21), (384, 24, 5, 16, 24),
    (385, 20, 5, 11, 7, 5), (390, 32, 5, 26, 15), (392, 32, 5, 14, 28), (396, 24, 5, 18, 22),
    (400, 32, 5, 20, 20), (405, 32, 5, 27, 15), (416, 32, 4, 16, 26), (420, 24, 4, 20, 21),
    (429, 16, 4, 13, 11, 3), (432, 32, 4, 24, 18), (440, 24, 4, 20, 22), (441, 32, 4, 21, 21),
    (448, 32, 4, 28, 16), (450, 32, 4, 18, 25), (455, 24, 4, 13, 7, 5), (462, 24, 4, 22, 21),
    (468, 32, 4, 18, 26), (480, 24, 4, 20, 24), (484, 24, 4, 22, 22), (486, 32, 4, 18, 27),
    (490, 20, 4, 10, 7, 7), (495, 16, 4, 11, 9, 5), (500, 32, 4, 20, 25), (504, 32, 4, 24, 21),
    (507, 16, 8, 13, 13, 3), (520, 32, 3, 20, 26), (525, 32, 3, 21, 25), (528, 24, 3, 22, 24),
    (539, 16, 3, 11, 7, 7), (540, 32, 3, 20, 27), (546, 32, 3, 21, 26), (550, 32, 3, 22, 25),
    (560, 32, 3, 20, 28), (567, 32, 3, 21, 27), (572, 32, 3, 22, 26), (576, 32, 3, 24, 24),
    (585, 16, 3, 9, 13, 5), (588, 32, 3, 28, 21), (594, 32, 3, 27, 22), (600, 32, 3, 24, 25),
    (605, 20, 3, 11, 11, 5), (616, 32, 3, 28, 22), (624, 32, 3, 24, 26), (625, 32, 3, 25, 25),
    (630, 32, 3, 21, 30), (637, 20, 3, 13, 7, 7), (640, 32, 3, 20, 32), (648, 32, 3, 24, 27),
    (650, 32, 3, 26, 25), (660, 32, 3, 30, 22), (672, 32, 3, 28, 24), (675, 32, 3, 27, 25),
    (676, 32, 3, 26, 26), (686, 24, 2, 14, 7, 7), (693, 16, 2, 11, 9, 7), (700, 32, 2, 28, 25),
    (702, 32, 2, 27, 26), (704, 32, 2, 32, 22), (715, 16, 2, 11, 13, 5), (720, 32, 2, 24, 30),
    (726, 20, 2, 11, 11, 6), (728, 32, 2, 28, 26), (729, 32, 2, 27, 27), (735, 20, 2, 15, 7, 7),
    (750, 32, 2, 25, 30), (756, 32, 2, 28, 27), (768, 32, 2, 24, 32), (770, 16, 2, 11, 10, 7),
    (780, 32, 2, 30, 26), (784, 32, 2, 28, 28), (792, 16, 2, 9, 11, 8), (800, 32, 2, 25, 32),
    (810, 32, 2, 30, 27), (819, 16, 2, 9, 13, 7), (825, 16, 4, 15, 11, 5), (832, 32, 2, 32, 26),
    (840, 32, 2, 28, 30), (845, 24, 2, 13, 13, 5), (847, 20, 2, 11, 11, 7),
    (858, 20, 2, 13, 11, 6), (864, 32, 2, 32, 27), (875, 32, 4, 25, 7, 5),
    (880, 16, 2, 10, 11, 8), (882, 16, 2, 9, 14, 7), (891, 16, 2, 11, 9, 9), (896, 32, 2, 32, 28),
    (900, 32, 2, 30, 30), (910, 16, 2, 10, 13, 7), (924, 20, 2, 12, 11, 7),
    (936, 16, 2, 9, 13, 8), (945, 16, 2, 9, 15, 7), (960, 32, 2, 32, 30), (968, 16, 2, 11, 11, 8),
    (972, 16, 2, 12, 9, 9), (975, 24, 2, 15, 13, 5), (980, 16, 2, 10, 14, 7),
    (990, 16, 2, 11, 10, 9), (1001, 16, 2, 11, 13, 7), (1008, 20, 2, 12, 12, 7),
    (1014, 16, 2, 6, 13, 13), (1029, 24, 3, 21, 7, 7), (1040, 20, 1, 13, 10, 8),
    (1050, 20, 1, 15, 10, 7), (1053, 16, 1, 9, 9, 13), (1056, 20, 1, 12, 11, 8),
    (1078, 16, 1, 7, 11, 14), (1080, 20, 1, 12, 10, 9), (1089, 24, 1, 11, 11, 9),
    (1092, 16, 1, 7, 12, 13), (1100, 24, 1, 11, 10, 10), (1120, 20, 1, 14, 10, 8),
    (1125, 16, 1, 15, 15, 5), (1134, 16, 1, 9, 14, 9), (1144, 16, 1, 8, 11, 13),
    (1152, 16, 1, 12, 12, 8), (1155, 16, 1, 11, 15, 7), (1170, 20, 1, 13, 10, 9),
    (1176, 16, 1, 7, 12, 14), (1183, 16, 1, 7, 13, 13), (1188, 16, 1, 12, 11, 9),
    (1200, 16, 1, 10, 10, 12), (1210, 16, 1, 10, 11, 11), (1215, 20, 1, 15, 9, 9),
    (1225, 32, 3, 25, 7, 7), (1232, 32, 1, 14, 11, 8), (1248, 16, 1, 8, 12, 13),
    (1250, 32, 3, 25, 10, 5), (1260, 20, 1, 14, 10, 9), (1274, 16, 1, 14, 13, 7),
    (1280, 16, 1, 16, 10, 8), (1287, 16, 1, 9, 11, 13), (1296, 16, 1, 9, 12, 12),
    (1300, 16, 1, 10, 10, 13), (1320, 16, 1, 11, 12, 10), (1323, 32, 1, 21, 9, 7),
    (1331, 20, 1, 11, 11, 11), (1344, 16, 1, 8, 12, 14), (1350, 20, 1, 15, 10, 9),
    (1365, 16, 1, 7, 13, 15), (1372, 16, 2, 14, 14, 7), (1375, 32, 1, 11, 25, 5),
    (1386, 16, 1, 11, 14, 9), (1400, 16, 1, 10, 10, 14), (1404, 16, 1, 9, 12, 13),
    (1408, 20, 1, 16, 11, 8), (1430, 16, 1, 10, 11, 13), (1440, 16, 1, 10, 12, 12),
    (1452, 16, 1, 11, 12, 11), (1456, 16, 2, 14, 13, 8), (1458, 20, 1, 9, 9, 18),
    (1470, 16, 2, 15, 14, 7), (1485, 16, 1, 9, 11, 15), (1500, 16, 1, 10, 10, 15),
    (1512, 16, 1, 9, 12, 14), (1521, 16, 1, 9, 13, 13), (1540, 16, 1, 11, 14, 10),
    (1560, 16, 1, 10, 12, 13), (1568, 16, 2, 14, 14, 8), (1573, 16, 1, 11, 13, 11),
    (1575, 16, 2, 15, 15, 7), (1584, 16, 1, 11, 12, 12), (1600, 16, 1, 16, 10, 10),
    (1617, 24, 2, 21, 11, 7), (1620, 16, 1, 12, 15, 9), (1625, 32, 1, 5, 13, 25),
    (1638, 16, 1, 9, 13, 14), (1650, 16, 1, 10, 11, 15), (1664, 20, 1, 16, 13, 8),
    (1680, 16, 1, 10, 12, 14), (1690, 16, 1, 10, 13, 13), (1694, 16, 1, 11, 14, 11),
    (1701, 24, 1, 9, 9, 21), (1715, 16, 1, 5, 7, 7, 7), (1716, 16, 1, 11, 12, 13),
    (1728, 16, 2, 12, 12, 12), (1750, 32, 1, 7, 10, 25), (1755, 16, 1, 9, 13, 15),
    (1760, 16, 1, 11, 16, 10), (1764, 16, 1, 14, 14, 9), (1782, 20, 1, 18, 11, 9),
    (1792, 20, 1, 16, 14, 8), (1800, 16, 1, 10, 12, 15), (1815, 16, 1, 11, 11, 15),
    (1820, 16, 1, 14, 13, 10), (1848, 20, 1, 14, 12, 11), (1872, 16, 1, 12, 12, 13),
    (1875, 32, 1, 15, 25, 5), (1890, 16, 1, 9, 14, 15), (1911, 24, 1, 21, 13, 7),
    (1920, 16, 1, 12, 16, 10), (1925, 32, 1, 11, 25, 7), (1936, 20, 1, 16, 11, 11),
    (1944, 24, 1, 18, 12, 9), (1950, 16, 1, 10, 13, 15), (1960, 16, 1, 10, 14, 14),
    (1980, 16, 1, 15, 12, 11), (2000, 24, 1, 20, 10, 10), (2002, 20, 1, 14, 13, 11),
    (2016, 16, 1, 14, 12, 12), (2025, 24, 1, 15, 15, 9), (2028, 16, 1, 12, 13, 13),
    (2058, 24, 1, 21, 14, 7), (2080, 16, 1, 16, 13, 10), (2100, 16, 1, 10, 14, 15),
    (2106, 20, 1, 18, 13, 9), (2112, 16, 1, 16, 12, 11), (2145, 16, 1, 15, 13, 11),
    (2156, 16, 1, 11, 14, 14), (2160, 16, 1, 15, 12, 12), (2178, 24, 1, 18, 11, 11),
    (2184, 16, 1, 12, 13, 14), (2187, 32, 1, 27, 9, 9), (2200, 24, 1, 20, 11, 10),
    (2205, 24, 1, 15, 21, 7), (2240, 16, 1, 16, 14, 10), (2250, 20, 1, 15, 15, 10),
    (2268, 20, 1, 18, 14, 9), (2275, 32, 1, 13, 25, 7), (2288, 16, 1, 16, 13, 11),
    (2304, 20, 1, 16, 12, 12), (2340, 16, 1, 12, 13, 15), (2352, 16, 1, 12, 14, 14),
    (2366, 16, 1, 14, 13, 13), (2376, 20, 1, 18, 12, 11), (2400, 20, 1, 16, 15, 10),
    (2401, 16, 1, 7, 7, 7, 7), (2420, 20, 1, 11, 11, 20), (2430, 20, 1, 18, 15, 9),
    (2450, 32, 1, 14, 25, 7), (2457, 24, 1, 21, 13, 9), (2464, 16, 1, 14, 16, 11),
    (2475, 16, 1, 15, 15, 11), (2496, 16, 1, 12, 13, 16), (2500, 32, 1, 25, 10, 10),
    (2520, 16, 1, 12, 14, 15), (2535, 16, 1, 15, 13, 13), (2541, 24, 1, 11, 21, 11),
    (2548, 16, 1, 14, 14, 13), (2560, 24, 1, 16, 16, 10), (2574, 20, 1, 18, 13, 11),
    (2592, 24, 1, 18, 12, 12), (2600, 20, 1, 20, 13, 10), (2625, 32, 1, 7, 15, 25),
    (2640, 16, 1, 16, 15, 11), (2646, 32, 1, 21, 14, 9), (2662, 24, 1, 11, 11, 22),
    (2673, 32, 1, 11, 27, 9), (2688, 16, 1, 14, 16, 12), (2695, 24, 1, 11, 7, 7, 5),
    (2700, 16, 1, 12, 15, 15), (2704, 16, 1, 16, 13, 13), (2730, 16, 1, 14, 15, 13),
    (2744, 16, 1, 14, 14, 14), (2750, 32, 1, 11, 25, 10), (2772, 20, 1, 18, 14, 11),
    (2800, 20, 1, 20, 14, 10), (2808, 20, 1, 12, 13, 18), (2816, 16, 1, 16, 16, 11),
    (2835, 24, 1, 15, 21, 9), (2860, 20, 1, 11, 13, 20), (2880, 16, 1, 16, 15, 12),
    (2904, 24, 1, 22, 12, 11), (2912, 20, 1, 16, 14, 13), (2916, 20, 1, 9, 18, 18),
    (2925, 16, 1, 15, 15, 13), (2940, 16, 1, 15, 14, 14), (2970, 20, 1, 11, 15, 18),
    (3003, 32, 1, 21, 13, 11), (3024, 20, 1, 18, 14, 12), (3025, 32, 1, 11, 11, 25),
    (3042, 20, 1, 18, 13, 13), (3080, 20, 1, 11, 14, 20), (3087, 24, 1, 21, 21, 7),
    (3120, 16, 1, 16, 15, 13), (3125, 32, 1, 25, 25, 5), (3136, 20, 1, 16, 14, 14),
    (3146, 32, 1, 22, 13, 11), (3150, 16, 1, 15, 15, 14), (3159, 32, 1, 13, 27, 9),
    (3168, 20, 1, 16, 18, 11), (3185, 16, 1, 13, 7, 7, 5), (3200, 20, 1, 16, 20, 10),
    (3234, 32, 1, 21, 14, 11), (3240, 20, 1, 12, 15, 18), (3250, 32, 1, 13, 25, 10),
    (3267, 32, 1, 11, 27, 11), (3276, 20, 1, 14, 18, 13), (3300, 20, 1, 15, 20, 11),
    (3328, 16, 1, 16, 16, 13), (3360, 16, 1, 15, 16, 14), (3375, 16, 1, 15, 15, 15),
    (3380, 24, 1, 20, 13, 13), (3388, 32, 1, 22, 14, 11), (3402, 24, 1, 18, 21, 9),
    (3430, 20, 1, 10, 7, 7, 7), (3432, 32, 1, 22, 13, 12), (3456, 20, 1, 16, 18, 12),
    (3465, 24, 1, 15, 21, 11), (3500, 32, 1, 25, 14, 10), (3510, 20, 1, 18, 15, 13),
    (3520, 20, 1, 16, 20, 11), (3528, 20, 1, 18, 14, 14), (3549, 24, 1, 13, 13, 21),
    (3564, 20, 1, 18, 18, 11), (3575, 32, 1, 25, 13, 11), (3584, 16, 1, 16, 16, 14),
    (3600, 16, 1, 16, 15, 15), (3630, 24, 1, 15, 22, 11), (3640, 20, 1, 20, 14, 13),
    (3645, 32, 1, 15, 27, 9), (3675, 32, 1, 21, 25, 7), (3696, 24, 1, 16, 21, 11),
    (3744, 20, 1, 16, 18, 13), (3750, 32, 1, 15, 25, 10), (3773, 24, 1, 11, 7, 7, 7),
    (3780, 20, 1, 14, 15, 18), (3822, 24, 1, 13, 14, 21), (3840, 16, 1, 16, 16, 15),
    (3850, 32, 1, 11, 14, 25), (3861, 32, 1, 27, 13, 11), (3872, 24, 1, 16, 22, 11),
    (3888, 20, 1, 18, 18, 12), (3900, 24, 1, 20, 15, 13), (3920, 20, 1, 20, 14, 14),
    (3960, 20, 1, 20, 18, 11), (3969, 24, 1, 21, 21, 9), (3993, 16, 1, 11, 11, 11, 3),
    (4000, 20, 1, 10, 20, 20), (4004, 24, 1, 13, 14, 22), (4032, 20, 1, 16, 18, 14),
    (4050, 20, 1, 15, 18, 15), (4056, 24, 1, 24, 13, 13), (4095, 24, 1, 13, 15, 21),
    (4116, 24, 1, 14, 14, 21), (4125, 32, 1, 25, 15, 11), (4158, 24, 1, 21, 18, 11),
    (4160, 20, 1, 16, 20, 13), (4200, 24, 1, 20, 15, 14), (4212, 20, 1, 18, 18, 13),
    (4224, 24, 1, 16, 22, 12), (4225, 32, 1, 25, 13, 13), (4235, 16, 1, 11, 11, 7, 5),
    (4290, 32, 1, 22, 15, 13), (4312, 24, 1, 14, 14, 22), (4320, 20, 1, 16, 18, 15),
    (4356, 24, 1, 18, 22, 11), (4368, 32, 1, 21, 16, 13), (4374, 32, 1, 27, 18, 9),
    (4375, 32, 1, 25, 25, 7), (4400, 32, 1, 20, 20, 11), (4410, 24, 1, 14, 15, 21),
    (4455, 32, 1, 27, 15, 11), (4459, 20, 1, 13, 7, 7, 7), (4480, 20, 1, 16, 20, 14),
    (4500, 20, 1, 20, 15, 15), (4536, 20, 1, 18, 18, 14), (4550, 32, 1, 25, 14, 13),
    (4563, 32, 1, 13, 27, 13), (4576, 32, 1, 22, 16, 13), (4608, 20, 1, 16, 18, 16),
    (4620, 32, 1, 21, 20, 11), (4680, 20, 1, 20, 18, 13), (4704, 32, 1, 21, 16, 14),
    (4719, 16, 1, 11, 13, 11, 3), (4725, 24, 1, 15, 15, 21), (4732, 32, 1, 13, 14, 26),
    (4752, 24, 1, 22, 18, 12), (4800, 20, 1, 16, 20, 15), (4802, 20, 1, 14, 7, 7, 7),
    (4840, 24, 1, 22, 20, 11), (4851, 32, 1, 21, 21, 11), (4860, 20, 1, 18, 18, 15),
    (4875, 32, 1, 15, 25, 13), (4900, 32, 1, 25, 14, 14), (4914, 24, 1, 13, 18, 21),
    (4928, 32, 1, 22, 16, 14), (4950, 32, 1, 22, 15, 15), (4992, 32, 1, 24, 16, 13),
    (5000, 32, 1, 20, 25, 10), (5005, 32, 1, 13, 11, 7, 5), (5040, 20, 1, 18, 20, 14),
    (5070, 32, 1, 15, 26, 13), (5082, 24, 1, 22, 21, 11), (5096, 32, 1, 14, 14, 26),
    (5103, 32, 1, 21, 27, 9), (5145, 16, 1, 15, 7, 7, 7), (5148, 24, 1, 18, 22, 13),
    (5184, 20, 1, 16, 18, 18), (5200, 20, 1, 13, 20, 20), (5250, 32, 1, 14, 15, 25),
    (5265, 32, 1, 15, 27, 13), (5280, 32, 1, 22, 16, 15), (5292, 24, 1, 14, 18, 21),
    (5324, 24, 1, 22, 22, 11), (5346, 32, 1, 18, 27, 11), (5376, 32, 1, 21, 16, 16),
    (5390, 24, 1, 11, 10, 7, 7), (5400, 20, 1, 15, 18, 20), (5408, 32, 1, 13, 16, 26),
    (5445, 24, 1, 11, 11, 9, 5), (5460, 24, 1, 13, 20, 21), (5488, 32, 1, 14, 28, 14),
    (5500, 32, 1, 20, 25, 11), (5544, 24, 1, 18, 22, 14), (5600, 20, 1, 14, 20, 20),
    (5616, 24, 1, 18, 24, 13), (5625, 32, 1, 25, 15, 15), (5632, 32, 1, 22, 16, 16),
    (5670, 24, 1, 15, 18, 21), (5720, 24, 1, 13, 20, 22), (5733, 24, 1, 13, 21, 21),
    (5760, 20, 1, 16, 18, 20), (5775, 32, 1, 21, 25, 11), (5808, 24, 1, 22, 22, 12),
    (5824, 32, 1, 14, 16, 26), (5832, 20, 1, 18, 18, 18), (5850, 32, 1, 25, 18, 13),
    (5880, 24, 1, 14, 20, 21), (5915, 32, 1, 13, 13, 7, 5), (5929, 24, 1, 11, 11, 7, 7),
    (5940, 24, 1, 15, 18, 22), (6006, 24, 1, 13, 21, 22), (6048, 24, 1, 16, 18, 21),
    (6050, 32, 1, 22, 25, 11), (6075, 32, 1, 15, 27, 15), (6084, 32, 1, 18, 26, 13),
    (6125, 32, 1, 7, 25, 7, 5), (6160, 24, 1, 14, 20, 22), (6174, 24, 1, 14, 21, 21),
    (6237, 32, 1, 21, 27, 11), (6240, 24, 1, 13, 20, 24), (6250, 32, 1, 25, 25, 10),
    (6272, 32, 1, 14, 16, 28), (6292, 24, 1, 13, 22, 22), (6300, 24, 1, 15, 20, 21),
    (6318, 32, 1, 27, 18, 13), (6336, 24, 1, 16, 18, 22), (6370, 32, 1, 13, 10, 7, 7),
    (6400, 20, 1, 16, 20, 20), (6435, 16, 1, 11, 13, 9, 5), (6468, 24, 1, 14, 21, 22),
    (6480, 20, 1, 18, 18, 20), (6500, 32, 1, 20, 25, 13), (6534, 32, 1, 22, 27, 11),
    (6552, 24, 1, 13, 21, 24), (6561, 32, 1, 27, 27, 9), (6600, 24, 1, 15, 20, 22),
    (6615, 24, 1, 15, 21, 21), (6655, 20, 1, 11, 11, 11, 5), (6656, 32, 1, 16, 16, 26),
    (6720, 24, 1, 16, 20, 21), (6750, 32, 1, 15, 18, 25), (6760, 32, 1, 20, 26, 13),
    (6776, 24, 1, 14, 22, 22), (6804, 24, 1, 18, 18, 21), (6825, 32, 1, 21, 25, 13),
    (6860, 20, 1, 14, 10, 7, 7), (6864, 24, 1, 13, 22, 24), (6875, 32, 1, 25, 25, 11),
    (6912, 24, 1, 16, 18, 24), (6930, 24, 1, 15, 21, 22), (7000, 32, 1, 20, 25, 14),
    (7007, 16, 1, 11, 13, 7, 7), (7020, 32, 1, 15, 18, 26), (7040, 24, 1, 16, 20, 22),
    (7056, 24, 1, 16, 21, 21), (7098, 32, 1, 21, 26, 13), (7128, 24, 1, 18, 22, 18),
    (7150, 32, 1, 22, 25, 13), (7168, 32, 1, 28, 16, 16), (7200, 24, 1, 20, 20, 18),
    (7260, 24, 1, 15, 22, 22), (7280, 32, 1, 20, 26, 14), (7290, 32, 1, 18, 27, 15),
    (7350, 32, 1, 21, 25, 14), (7371, 32, 1, 21, 27, 13), (7392, 24, 1, 16, 21, 22),
    (7425, 32, 1, 25, 27, 11), (7488, 24, 1, 13, 24, 24), (7500, 32, 1, 20, 25, 15),
    (7546, 16, 1, 11, 14, 7, 7), (7560, 24, 1, 21, 20, 18), (7605, 24, 1, 13, 13, 9, 5),
    (7623, 20, 1, 11, 11, 9, 7), (7644, 32, 1, 21, 26, 14), (7680, 24, 1, 16, 20, 24),
    (7700, 32, 1, 22, 25, 14), (7722, 32, 1, 22, 27, 13), (7744, 24, 1, 16, 22, 22),
    (7776, 24, 1, 18, 24, 18), (7800, 32, 1, 24, 25, 13), (7840, 32, 1, 20, 28, 14),
    (7865, 16, 1, 11, 13, 11, 5), (7875, 32, 1, 21, 25, 15), (7920, 24, 1, 20, 22, 18),
    (7938, 24, 1, 21, 21, 18), (7986, 16, 1, 11, 11, 11, 6), (8000, 32, 1, 20, 20, 20),
    (8008, 32, 1, 22, 26, 14), (8019, 32, 1, 11, 27, 27), (8064, 24, 1, 16, 21, 24),
    (8085, 16, 1, 11, 15, 7, 7), (8100, 32, 1, 18, 18, 25), (8112, 32, 1, 13, 24, 26),
    (8125, 32, 1, 25, 25, 13), (8190, 32, 1, 15, 21, 26), (8250, 32, 1, 15, 22, 25),
    (8281, 24, 1, 13, 13, 7, 7), (8316, 24, 1, 21, 22, 18), (8320, 32, 1, 20, 26, 16),
    (8400, 24, 1, 20, 21, 20), (8424, 32, 1, 18, 26, 18), (8448, 24, 1, 16, 22, 24),
    (8470, 24, 1, 11, 11, 10, 7), (8505, 32, 1, 21, 27, 15), (8580, 32, 1, 15, 22, 26),
    (8624, 32, 1, 14, 22, 28), (8640, 24, 1, 20, 24, 18), (8712, 24, 1, 18, 22, 22),
    (8736, 32, 1, 21, 26, 16), (8748, 32, 1, 18, 18, 27), (8750, 32, 1, 25, 25, 14),
    (8775, 32, 1, 25, 27, 13), (8800, 24, 1, 20, 20, 22), (8820, 24, 1, 20, 21, 21),
    (8910, 32, 1, 27, 22, 15), (8918, 20, 1, 14, 13, 7, 7), (8960, 32, 1, 20, 28, 16),
    (9000, 32, 1, 18, 20, 25), (9009, 32, 1, 11, 13, 9, 7), (9072, 24, 1, 24, 21, 18),
    (9075, 24, 1, 15, 11, 11, 5), (9100, 32, 1, 14, 25, 26), (9126, 32, 1, 13, 26, 27),
    (9152, 32, 1, 16, 22, 26), (9240, 24, 1, 20, 21, 22), (9317, 24, 1, 11, 11, 11, 7),
    (9360, 64, 1, 20, 26, 18), (9375, 32, 1, 25, 25, 15), (9408, 32, 1, 21, 28, 16),
    (9438, 32, 1, 11, 13, 11, 6), (9450, 64, 1, 21, 25, 18), (9464, 32, 1, 26, 26, 14),
    (9477, 32, 1, 13, 27, 27), (9504, 24, 1, 24, 22, 18), (9555, 16, 1, 15, 13, 7, 7),
    (9600, 24, 1, 20, 20, 24), (9604, 20, 1, 14, 14, 7, 7), (9625, 32, 1, 11, 25, 7, 5),
    (9680, 32, 1, 22, 22, 20), (9702, 24, 1, 21, 22, 21), (9720, 64, 1, 20, 27, 18),
    (9750, 32, 1, 26, 25, 15), (9800, 32, 1, 25, 28, 14), (9801, 24, 1, 9, 9, 11, 11),
    (9828, 64, 1, 26, 21, 18), (9856, 32, 1, 22, 28, 16), (9900, 64, 1, 22, 25, 18),
    (9984, 32, 1, 24, 26, 16), (10000, 32, 1, 20, 20, 25), (10010, 32, 1, 11, 13, 10, 7),
    (10080, 24, 1, 20, 21, 24), (10125, 32, 1, 27, 25, 15), (10164, 24, 1, 21, 22, 22),
    (10192, 32, 1, 14, 26, 28), (10206, 64, 1, 21, 27, 18), (10240, 32, 1, 20, 32, 16),
    (10290, 16, 1, 15, 14, 7, 7), (10296, 64, 1, 22, 26, 18), (10368, 24, 1, 18, 24, 24),
    (10395, 32, 1, 11, 15, 9, 7), (10400, 64, 1, 26, 20, 20), (10500, 64, 1, 20, 21, 25),
    (10530, 32, 1, 15, 26, 27), (10560, 24, 1, 20, 22, 24), (10584, 32, 1, 24, 21, 21),
    (10647, 32, 1, 13, 13, 9, 7), (10648, 32, 1, 22, 22, 22), (10692, 64, 1, 22, 27, 18),
    (10752, 32, 1, 16, 24, 28), (10780, 32, 1, 11, 14, 10, 7), (10800, 64, 1, 25, 24, 18),
    (10816, 32, 1, 16, 26, 26), (10890, 24, 1, 9, 10, 11, 11), (10920, 64, 1, 21, 26, 20),
    (10976, 32, 1, 14, 28, 28), (11000, 64, 1, 22, 25, 20), (11011, 32, 1, 11, 13, 11, 7),
    (11025, 64, 1, 21, 25, 21), (11088, 24, 1, 22, 24, 21), (11200, 64, 1, 28, 20, 20),
    (11232, 64, 1, 24, 26, 18), (11250, 64, 1, 25, 25, 18), (11264, 32, 1, 16, 22, 32),
    (11340, 64, 1, 21, 27, 20), (11375, 32, 1, 13, 25, 7, 5), (11440, 64, 1, 22, 26, 20),
    (11466, 64, 1, 21, 26, 21), (11520, 24, 1, 24, 24, 20), (11550, 64, 1, 22, 25, 21),
    (11616, 24, 1, 22, 24, 22), (11648, 32, 1, 28, 26, 16), (11664, 64, 1, 24, 27, 18),
    (11700, 64, 1, 25, 26, 18), (11760, 64, 1, 21, 28, 20), (11880, 64, 1, 22, 27, 20),
    (12000, 64, 1, 25, 24, 20), (12096, 24, 1, 21, 24, 24), (12100, 64, 1, 25, 22, 22),
    (12168, 64, 1, 26, 26, 18), (12250, 32, 1, 25, 10, 7, 7), (12285, 32, 1, 13, 15, 9, 7),
    (12320, 64, 1, 20, 22, 28), (12348, 64, 1, 21, 28, 21), (12474, 64, 1, 21, 22, 27),
    (12480, 64, 1, 20, 24, 26), (12500, 64, 1, 20, 25, 25), (12544, 32, 1, 16, 28, 28),
    (12584, 64, 1, 22, 22, 26), (12600, 64, 1, 24, 25, 21), (12636, 64, 1, 27, 26, 18),
    (12672, 24, 1, 22, 24, 24), (12800, 64, 1, 32, 20, 20), (12960, 64, 1, 20, 24, 27),
    (13000, 64, 1, 20, 25, 26), (13068, 64, 1, 22, 22, 27), (13104, 64, 1, 21, 24, 26),
    (13125, 64, 1, 21, 25, 25), (13200, 64, 1, 24, 25, 22), (13230, 64, 1, 21, 30, 21),
    (13312, 32, 1, 16, 26, 32), (13440, 64, 1, 20, 24, 28), (13500, 64, 1, 20, 25, 27),
    (13552, 64, 1, 22, 28, 22), (13608, 64, 1, 21, 24, 27), (13750, 64, 1, 25, 25, 22),
    (13824, 24, 1, 24, 24, 24), (13860, 64, 1, 30, 22, 21), (14000, 64, 1, 25, 28, 20),
    (14040, 64, 1, 27, 26, 20), (14080, 64, 1, 32, 22, 20), (14112, 64, 1, 21, 24, 28),
    (14400, 64, 1, 25, 24, 24),
)
GENERAL_LINES = {e[0]: GeneralLine(e[1], e[2], tuple(e[3:])) for e in _GENERAL}

# the cluster design (csrc/cluster.cuh, one kernel a class for K1 and K2):
# its cluster sizes, and its classes (cluster::max_threads): the most points
# a thread holds -> the most threads a CTA (the least radix as in
# GENERAL_CLASSES)
CLUSTER_HEADER = Path(__file__).resolve().parent.parent / "csrc" / "cluster.cuh"
CLUSTER_SIZES = (2, 4, 8)
CLUSTER_CLASSES = {24: 512, 32: 512, 64: 352}
ALL_COLUMNS = 1 << 40   # kAllColumns (csrc/cols_fixed.cuh): an entry with no upper end


def read_table(text: str, name: str) -> Tuple[Tuple[int, ...], ...]:
    """The entries of the X-macro table ``name`` (``#define name(X) X(...)
    X(...) ...``) in the text of a C header, in order, each a tuple of
    ints (``kAllColumns`` read as ``ALL_COLUMNS``): the one copy of a
    table that the C rule compiles and Python reads."""
    body = re.search(rf"#define {name}\(X\)((?:.*\\\n)*.*)\n", text)
    if body is None:
        raise ValueError(f"radix: the header has no {name}(X)")
    return tuple(tuple(ALL_COLUMNS if a.strip() == "kAllColumns" else int(a)
                       for a in args.split(","))
                 for args in re.findall(r"X\(([^)]*)\)", body.group(1)))


class ClusterLine(NamedTuple):
    """A length's entry in K1's cluster design's table."""
    points: int               # the most points a thread holds: the kernel's class
    clusters: int             # CTAs a cluster, a line split over them
    chain: Tuple[int, ...]    # the first radix across the cluster


# N -> (points, clusters, chain) of the cluster design (csrc/cluster.cu): the
# lengths from 11583 that no single CTA of the general design holds, where
# its sweep on the H100 beat the direct design at both line counts; read
# from WGFFT_CLUSTER_LINES of csrc/cluster.cuh, which
# chip_probes/k1_general_variants.py --cluster --fit writes
CLUSTER_LINES = {e[0]: ClusterLine(e[1], e[2], tuple(e[3:]))
                 for e in read_table(CLUSTER_HEADER.read_text(), "WGFFT_CLUSTER_LINES")}


@lru_cache(maxsize=None)
def radix_chain(n: int) -> Tuple[int, ...]:
    """The radices of the passes for length ``n``, largest first; their
    product is ``n``.

    The odd primes come from ``factors.factorize_supported_radices``.  The
    power of two 2^a is spread over ceil(a / 4) passes as evenly as it goes,
    in radices up to 16 (2^8 = 16 * 16, 2^10 = 16 * 8 * 8, 2^5 = 8 * 4): an
    inner pass costs a trip through shared memory and two barriers whatever
    its radix, so fewer, wider passes win as long as a butterfly's points fit
    a thread's registers."""
    greedy = factors.factorize_supported_radices(n)
    if not greedy or n < 2:
        raise ValueError(f"radix_chain: {n} is not a product of {KERNEL_RADICES}")
    chain = [r for r in greedy if r % 2]
    a = (n // math.prod(chain)).bit_length() - 1
    passes = -(-a // 4)
    chain += [1 << (a // passes + (i < a % passes)) for i in range(passes)]
    chain.sort(reverse=True)
    if len(chain) > MAX_PASSES:
        raise ValueError(f"radix_chain: {n} needs {len(chain)} passes, over {MAX_PASSES}")
    return tuple(chain)


_DESIGNS = {"pow2": POW2_LINES, "warp": WARP_LINES, "mixed": MIXED_LINES,
            "packed": PACKED_LINES,
            "general": {n: line.chain for n, line in GENERAL_LINES.items()},
            "cluster": {n: line.chain for n, line in CLUSTER_LINES.items()}}


def lines_chain(n: int) -> Tuple[int, ...]:
    """K1's chain for length ``n``: the power-of-two, the warp, the
    mixed-radix, the packed, the general or the cluster design's where
    ``POW2_LINES``, ``WARP_LINES``, ``MIXED_LINES``, ``PACKED_LINES``,
    ``GENERAL_LINES`` or ``CLUSTER_LINES`` names ``n``, ``radix_chain(n)``
    (the direct design's) everywhere else.
    K1's ``cw`` table is laid out for this chain."""
    return next((table[n] for table in _DESIGNS.values() if n in table), None) or radix_chain(n)


def lines_design(n: int) -> str:
    """The design K1's entry point launches for length ``n``: ``"pow2"``,
    ``"warp"``, ``"mixed"``, ``"packed"``, ``"general"``, ``"cluster"`` or
    ``"direct"``."""
    return next((name for name, table in _DESIGNS.items() if n in table), "direct")


def general_shared(n: int, chain: Sequence[int], lines: int) -> int:
    """Bytes of shared memory a CTA of the general design takes for
    ``chain`` over ``lines`` lines of ``n``: the exchanges' buffers (two,
    one for a chain of two passes) of ``lines`` lines at the longest
    exchange's padded extent (one point in every ns * R after a pass of even
    radix R)."""
    pitch, ns = n, 1
    for r in chain[:-1]:
        if r % 2 == 0:
            pitch = max(pitch, n + (n - 1) // (ns * r))
        ns *= r
    return (2 if len(chain) > 2 else 1) * lines * pitch * 8


def general_threads(n: int, chain: Sequence[int], points: int, lines: int) -> Optional[int]:
    """Threads a CTA of the general design takes for ``chain`` over
    ``lines`` lines of ``n`` with at most ``points`` points a thread: enough
    that every pass's butterflies fit in points // R rounds (the C
    ``make_plan``); None where the C ``make_plan`` refuses the shape:
    ``points`` is no class, a radix is outside the class's, the class has
    too few threads or the CTA's shared memory (``general_shared``) is over
    227 KB."""
    least, most = GENERAL_CLASSES.get(points, (points + 1, 0))
    if any(not least <= r <= points for r in chain) or general_shared(n, chain, lines) > 227 << 10:
        return None
    threads = max(-(-(lines * (n // r)) // (points // r)) for r in chain)
    return threads if threads <= most else None


def cluster_plan(h: int, chain: Sequence[int], points: int, tile: int,
                 clusters: int) -> Optional[Tuple[int, int]]:
    """(threads, shared bytes) of a CTA of the cluster design for ``chain``
    down a tile of ``tile`` columns of height ``h`` (K1: a line, tile 1)
    split over ``clusters`` CTAs with at most ``points`` points a thread (the
    C ``cluster::make_plan``), or None where it refuses the shape: a class
    or cluster size it has no kernel for, not two to four passes of the
    class's radices that multiply to ``h``, a first radix under
    2 * ``clusters``, a tile that is no power of two up to 64, too many
    threads for the class, or over 227 KB of shared memory.  A CTA holds Q
    = ``chain[0] // clusters`` or one more classes of the first pass, Q *
    h / chain[0] points, in two exchange buffers (one for two passes), one
    row of padding in every Q after the first pass where Q is even and in
    every ns * R after a later pass of even radix R, where the tile is
    narrower than 16 columns."""
    least = GENERAL_CLASSES.get(points, (points + 1, 0))[0]
    most = CLUSTER_CLASSES.get(points, 0)
    if (points not in CLUSTER_CLASSES or clusters not in CLUSTER_SIZES
            or not 2 <= len(chain) <= 4 or math.prod(chain) != h or not 4 <= h <= MAX_LENGTH
            or any(r not in GENERAL_RADICES or not least <= r <= points for r in chain)
            or chain[0] < 2 * clusters or not 1 <= tile <= 64 or tile & (tile - 1)):
        return None
    pad = tile < 16
    m0 = h // chain[0]
    threads = -(-(-(-m0 // clusters) * tile) // (points // chain[0]))
    pitch = 0
    for q in {chain[0] // clusters, -(-chain[0] // clusters)}:
        n = q * m0
        pitch = max(pitch, n + ((n - 1) // q if pad and q % 2 == 0 else 0))
        ns = q
        for p, r in enumerate(chain[1:], 1):
            threads = max(threads, -(-(n // r * tile) // (points // r)))
            if pad and p + 1 < len(chain) and r % 2 == 0:
                pitch = max(pitch, n + (n - 1) // (ns * r))
            ns *= r
    smem = (2 if len(chain) > 2 else 1) * pitch * tile * 8
    return (threads, smem) if threads <= most and smem <= 227 << 10 else None


def lines_in_place(n: int) -> bool:
    """May K1 run length ``n`` in place (y = x)?  At every length of the
    packed design, whose warps read their whole block before they write it
    back, and wherever the chain has two passes or more (a barrier after the
    first pass separates the last read from the first write); a one-pass
    chain of the other designs is refused."""
    return n in PACKED_LINES or len(lines_chain(n)) > 1


def roots_table(n: int, direction: str) -> np.ndarray:
    """The n-th roots of unity W^j = exp(-+ 2*pi*i*j/n), j in [0, n), as
    float32 (n, 2) pairs, rounded once from float64."""
    sign = -1.0 if direction == "forward" else 1.0
    # cos and sin of a real angle: a complex exp divides a complex by n and
    # lands a quarter turn of n = 8232 at 2.8e-16 where cos gives 6.1e-17
    ang = sign * 2.0 * np.pi * np.arange(n, dtype=np.float64) / n
    return np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)


def chain_twiddles(n: int, direction: str, radices: Sequence[int]) -> np.ndarray:
    """The roots table gathered into pass order, float32 (n, 2).

    Pass p (ns, R) owns entries [ns - 1, ns * R - 1): entry
    ns - 1 + (r - 1) * ns + k is W^(r * k * n / (ns * R)) for r in [1, R),
    k in [0, ns).  The passes' blocks tile [0, n - 1); the last entry is 1."""
    roots = roots_table(n, direction)
    index = np.zeros(n, dtype=np.int64)
    ns = 1
    for radix in radices:
        step = n // (ns * radix)
        r = np.arange(1, radix)[:, None]
        k = np.arange(ns)[None, :]
        index[ns - 1:ns * radix - 1] = (r * k * step).reshape(-1)
        ns *= radix
    if ns != n:
        raise ValueError(f"chain_twiddles: radices {tuple(radices)} do not multiply to {n}")
    return np.ascontiguousarray(roots[index])


def chain_consts(n: int, direction: str, scale: float, prefix: str,
                 chain: Optional[Sequence[int]] = None) -> Dict[str, np.ndarray]:
    """What the CUDA kernels read, from n, direction and scale alone:
    ``cw`` the twiddles (n, 2) in the order of ``chain`` (default
    ``radix_chain(n)``, K2's and K1's direct design's), and ``cp`` =
    [scale, sign] with sign -1 for forward and +1 for inverse."""
    sign = -1.0 if direction == "forward" else 1.0
    return {
        f"{prefix}/cw": chain_twiddles(n, direction, chain or radix_chain(n)),
        f"{prefix}/cp": np.array([scale, sign], dtype=np.float32),
    }


@lru_cache(maxsize=None)
def _direct_twiddles(n: int, direction: str, device: str) -> torch.Tensor:
    return torch.as_tensor(chain_twiddles(n, direction, radix_chain(n)), device=device)


def direct_tables(tables: Dict[str, torch.Tensor], n: int) -> Dict[str, torch.Tensor]:
    """K1's tables for length ``n`` (``fused.lines_consts``, laid out for
    ``lines_chain(n)``) with ``cw`` laid out for the direct design's chain
    ``radix_chain(n)`` instead, for the probes that run that design at any
    length: ``tables`` itself where the two chains agree, else a copy whose
    ``cw`` is built for the direction that ``cp``'s sign gives, on ``cw``'s
    device."""
    if lines_chain(n) == radix_chain(n):
        return tables
    direction = "forward" if float(tables["cp"][1]) < 0 else "inverse"
    return {**tables, "cw": _direct_twiddles(n, direction, str(tables["cw"].device))}


# ---------------------------------------------------------------------------
# the CPU model of the kernels' pass schedule
# ---------------------------------------------------------------------------

def _muli(v: torch.Tensor, s: float) -> torch.Tensor:
    """v * (i * s) on (..., 2) pairs."""
    return torch.stack([-s * v[..., 1], s * v[..., 0]], dim=-1)


def _butterfly2(v, s):
    return [v[0] + v[1], v[0] - v[1]]


def _butterfly4(v, s):
    t0, t1 = v[0] + v[2], v[0] - v[2]
    t2, t3 = v[1] + v[3], _muli(v[1] - v[3], s)
    return [t0 + t2, t1 + t3, t0 - t2, t1 - t3]


def _butterfly8(v, s):
    h = float(np.float32(math.sqrt(0.5)))
    e = _butterfly4([v[0], v[2], v[4], v[6]], s)
    o = _butterfly4([v[1], v[3], v[5], v[7]], s)
    x, y = o[1][..., 0], o[1][..., 1]
    o[1] = torch.stack([h * (x - s * y), h * (s * x + y)], dim=-1)
    o[2] = _muli(o[2], s)
    x, y = o[3][..., 0], o[3][..., 1]
    o[3] = torch.stack([h * (-x - s * y), h * (s * x - y)], dim=-1)
    return [e[q] + o[q] for q in range(4)] + [e[q] - o[q] for q in range(4)]


def _rot(v, c, si):
    """v * (c + i * si) on (..., 2) pairs."""
    x, y = v[..., 0], v[..., 1]
    return torch.stack([x * c - y * si, x * si + y * c], dim=-1)


def _butterfly16(v, s):
    """16 = 4 x 4: radix-4 on the residue classes of r mod 4, rotation of
    G_b[d] by w16^(b d), radix-4 across the classes; X[d + 4 c]."""
    h = float(np.float32(math.sqrt(0.5)))
    c1 = float(np.float32(math.cos(math.pi / 8)))
    s1 = float(np.float32(math.sin(math.pi / 8)))
    g = [_butterfly4([v[b], v[b + 4], v[b + 8], v[b + 12]], s) for b in range(4)]
    g[1][1] = _rot(g[1][1], c1, s * s1)
    g[1][2] = _rot(g[1][2], h, s * h)
    g[1][3] = _rot(g[1][3], s1, s * c1)
    g[2][1] = _rot(g[2][1], h, s * h)
    g[2][2] = _muli(g[2][2], s)
    g[2][3] = _rot(g[2][3], -h, s * h)
    g[3][1] = _rot(g[3][1], s1, s * c1)
    g[3][2] = _rot(g[3][2], -h, s * h)
    g[3][3] = _rot(g[3][3], -c1, -s * s1)
    out = [None] * 16
    for d in range(4):
        t = _butterfly4([g[0][d], g[1][d], g[2][d], g[3][d]], s)
        for c in range(4):
            out[d + 4 * c] = t[c]
    return out


def _f32(a: float) -> float:
    """``a`` rounded to float32, as a Python float (the CUDA literals)."""
    return float(np.float32(a))


def _butterfly32(v, s):
    """32 = 2 x 16: radix-16 on the even and odd points, the odd half
    rotated by w32^q, one radix-2 layer; X[q], X[q + 16] = E[q] +- w32^q O[q]."""
    e = _butterfly16(v[0::2], s)
    o = _butterfly16(v[1::2], s)
    for q in range(1, 16):
        if q == 8:
            o[q] = _muli(o[q], s)
        else:
            ang = math.pi * q / 16
            o[q] = _rot(o[q], _f32(math.cos(ang)), s * _f32(math.sin(ang)))
    return [e[q] + o[q] for q in range(16)] + [e[q] - o[q] for q in range(16)]


def _butterfly_odd(v, s):
    """Odd prime R: pairs a_k = v[k] + v[R-k], b_k = v[k] - v[R-k];
    X[q], X[R-q] = m_q +- i*s*n_q with m_q = v[0] + sum cos(2 pi q k / R) a_k
    and n_q = sum sin(2 pi q k / R) b_k."""
    radix = len(v)
    half = (radix - 1) // 2
    ang = 2.0 * np.pi * np.arange(radix) / radix
    # f32 values as Python floats: a numpy scalar cannot multiply a CUDA tensor
    cos = np.cos(ang).astype(np.float32).tolist()
    sin = np.sin(ang).astype(np.float32).tolist()
    a = [None] + [v[k] + v[radix - k] for k in range(1, half + 1)]
    b = [None] + [v[k] - v[radix - k] for k in range(1, half + 1)]
    out = [None] * radix
    out[0] = v[0] + sum(a[1:])
    for q in range(1, half + 1):
        m = v[0] + sum(cos[(q * k) % radix] * a[k] for k in range(1, half + 1))
        n = _muli(sum(sin[(q * k) % radix] * b[k] for k in range(1, half + 1)), s)
        out[q], out[radix - q] = m + n, m - n
    return out


def _turn(m: int, r: int):
    """cos and sin of 2 pi m / r rounded to float32, as Python floats (the
    constants of the mixed-radix design's composite butterflies)."""
    return _f32(math.cos(2.0 * math.pi * m / r)), _f32(math.sin(2.0 * math.pi * m / r))


def _rotate(v, m: int, r: int, s: float):
    """v * w^m with w = exp(s 2 pi i / r): quarter turns exactly, every other
    root by its float32 cos and sin (``mixed::rotate``)."""
    if 4 * m == r:
        return _muli(v, s)
    if 2 * m == r:
        return -v
    if 4 * m == 3 * r:
        return _muli(v, -s)
    c, si = _turn(m, r)
    return _rot(v, c, s * si)


def _first_factor(r: int) -> int:
    """A of a composite radix R = A * B: the power of two in R where R is
    even, else its least prime factor (``mixed::first_factor``)."""
    return r & -r if r % 2 == 0 else next(p for p in (3, 5, 7) if r % p == 0)


def _butterfly_composite(v, s):
    """Composite R = A * B (the mixed-radix design's ``Dft``): with
    n = B * n1 + n2, B DFTs of A points on the classes n2, G[n2][k1] rotated
    by w_R^(n2 k1), then A DFTs of B points across the classes;
    X[k1 + A * k2]."""
    radix = len(v)
    a = _first_factor(radix)
    b = radix // a
    g = [_butterfly(v[n2::b], s) for n2 in range(b)]
    for n2 in range(1, b):
        for k1 in range(1, a):
            g[n2][k1] = _rotate(g[n2][k1], n2 * k1, radix, s)
    out = [None] * radix
    for k1 in range(a):
        t = _butterfly([g[n2][k1] for n2 in range(b)], s)
        for k2 in range(b):
            out[k1 + a * k2] = t[k2]
    return out


_BUTTERFLIES = {2: _butterfly2, 4: _butterfly4, 8: _butterfly8, 16: _butterfly16,
                32: _butterfly32, **{r: _butterfly_composite for r in MIXED_RADICES}}


def _butterfly(v, s):
    """The R-point butterfly of the kernels for R = len(v)."""
    return _BUTTERFLIES.get(len(v), _butterfly_odd)(v, s)


def conj_pairs(x: torch.Tensor) -> torch.Tensor:
    """The complex conjugate of (..., 2) pairs, a new tensor."""
    return torch.stack([x[..., 0], -x[..., 1]], dim=-1)


def tracked(x: torch.Tensor) -> bool:
    """Does anything differentiate or batch through ``x`` right now: reverse
    mode (``x`` requires grad under grad mode), forward mode (a dual level is
    open) or a ``torch.func`` transform?  When not, a kernel wrapper may skip
    ``torch.autograd.Function.apply`` and launch directly."""
    return ((x.requires_grad and torch.is_grad_enabled())
            or torch._C._are_functorch_transforms_active()
            or torch.autograd.forward_ad._current_level >= 0)


def plain(x: torch.Tensor) -> bool:
    """May a kernel wrapper launch on ``x`` directly, without the dispatcher:
    is it a plain tensor that no tracing mode sees (no fake or functional
    tensor, no dispatch mode on the stack, as under ``torch.export``)?"""
    return type(x) is torch.Tensor and torch._C._len_torch_dispatch_stack() == 0


def table_list(tables: Dict[str, torch.Tensor], names: Sequence[str],
               kernel: str) -> List[torch.Tensor]:
    """A pass op's table argument: ``tables`` in the order of ``names``."""
    for name in names:
        if name not in tables:
            raise ValueError(f"{kernel}: missing table {name!r}")
    return [tables[name] for name in names]


def register_pass_op(op) -> None:
    """The fake implementation and the autograd of a pass op (K1, K2): the
    output is a new contiguous tensor of x's shape, and the backward is the
    op's adjoint launch on the same tables (the pass is y = s F x, so
    g_x = s F^H g_y)."""
    op.register_fake(
        lambda x, tables, adjoint: torch.empty_like(x, memory_format=torch.contiguous_format))

    def setup_context(ctx, inputs, output):
        _, ctx.tables, ctx.adjoint = inputs

    def backward(ctx, g):
        return op(g.contiguous(), ctx.tables, not ctx.adjoint), [None] * len(ctx.tables), None

    op.register_autograd(backward, setup_context=setup_context)


def packed_pitch(n: int, radices: Sequence[int], lanes: int) -> int:
    """Points a line of ``n`` takes in a stage of the packed design
    (``Shape::P`` of ``csrc/lines_packed.cuh``): with ``lanes`` > 1 its
    exchanges' extent (one point of padding in every ns * R after a pass of
    even radix R, the last pass in natural order), with one lane a line n
    (the passes run in registers); for odd n that alone (no radix is even,
    so it is n), else the least pitch from there up that is 2 mod 4 (one
    lane a line) or ``lanes`` mod 2 ``lanes``."""
    extent, ns = n, 1
    for r in radices[:-1] if lanes > 1 else ():
        if r % 2 == 0:
            extent = max(extent, n + (n - 1) // (ns * r))
        ns *= r
    if n % 2:
        return extent
    modulus, want = (4, 2) if lanes == 1 else (2 * lanes, lanes)
    return next(p for p in range(extent, extent + modulus) if p % modulus == want)


def packed_lines_reference(x: torch.Tensor, radices: Sequence[int],
                           tables: Dict[str, torch.Tensor], adjoint: bool = False,
                           lanes: int = 1, wide: bool = True) -> torch.Tensor:
    """The packed design's block-staged schedule in plain torch, along axis 1
    of float32 ``x`` (lines, N, 2): the lines in blocks of B = 32 / ``lanes``
    (the last block ragged); point q of a block landed in its stage at
    (q // N) * P + q % N (``packed_pitch``), as the 16-byte copies of
    ``csrc/lines_packed.cuh`` land it where ``wide`` (point 2c + 1 beside
    point 2c, the last point of an odd count alone) and the 8-byte copies
    otherwise; what no copy lands is NaN (the dead lines of the last block,
    the padding); the chain (``radix_chain_reference``) on every line of
    every stage, written back in natural order; and the live points copied
    out by the same map.  Returns a new tensor of x's shape."""
    lines, n = x.shape[0], x.shape[1]
    block = 32 // lanes
    pitch = packed_pitch(n, radices, lanes)
    blocks = -(-lines // block)
    g = torch.arange(lines * n, device=x.device)
    b, q = g // (block * n), g % (block * n)             # block, point in it
    live = torch.clamp(lines - b * block, max=block) * n   # points of its block

    def at(i):
        return (i // n) * pitch + i % n

    if wide:
        pair = q - q % 2
        tail = (live % 2 == 1) & (q == live - 1)
        dst = torch.where(tail, at(q), at(pair) + q % 2)
    else:
        dst = at(q)
    dst = dst + b * block * pitch
    stage = torch.full((blocks * block * pitch, 2), float("nan"), device=x.device)
    stage[dst] = x.reshape(-1, 2)
    grid = stage.view(blocks * block, pitch, 2)
    grid[:, :n] = radix_chain_reference(grid[:, :n], radices, tables, adjoint)
    return stage[dst].reshape(x.shape)


def radix_chain_reference(x: torch.Tensor, radices: Sequence[int],
                          tables: Dict[str, torch.Tensor],
                          adjoint: bool = False, stop: Optional[int] = None) -> torch.Tensor:
    """The kernels' pass schedule in plain torch, along axis 1 of float32
    ``x`` (units, N, ..., 2): the same passes, index maps, twiddle table
    (``cw``) and butterfly algebra, the scale (``cp[0]``) applied in the
    last pass.  ``adjoint`` conjugates on the first load and the last store,
    as the kernels' adjoint launch does.  ``stop`` cuts the chain after that
    many passes (0 .. len(radices)) and returns what the next pass would
    read, unscaled unless every pass ran.  Returns a new tensor of x's
    shape."""
    n = x.shape[1]
    if math.prod(radices) != n:
        raise ValueError(f"radix_chain_reference: radices {tuple(radices)} do not multiply to {n}")
    tw = tables["cw"]
    scale, s = float(tables["cp"][0]), float(tables["cp"][1])
    ride = (1,) * (x.dim() - 3) + (2,)            # broadcast over what trails axis 1
    cur = conj_pairs(x) if adjoint else x
    if stop is None:
        stop = len(radices)
    if not 0 <= stop <= len(radices):
        raise ValueError(f"radix_chain_reference: stop {stop} outside [0, {len(radices)}]")
    if stop < len(radices):
        scale = 1.0
    ns = 1
    for radix in radices[:stop]:
        m = n // radix
        # butterfly j = q * ns + k reads points j + r * m (a slice a radix
        # r), twiddled by W^(r * k * n / (ns * radix)) (entry
        # ns - 1 + (r - 1) * ns + k, the same for every q), and writes its
        # output r to (q * radix + r) * ns + k: plain slices and views, so
        # that no gather or scatter runs
        v = [cur[:, r * m:(r + 1) * m] for r in range(radix)]
        if ns > 1:
            for r in range(1, radix):
                row = tw[ns - 1 + (r - 1) * ns:ns - 1 + r * ns]
                w = row.repeat(m // ns, 1).reshape(1, m, *ride)
                wr, wi = w[..., 0], w[..., 1]
                vr, vi = v[r][..., 0], v[r][..., 1]
                v[r] = torch.stack([vr * wr - vi * wi, vr * wi + vi * wr], dim=-1)
        v = _butterfly(v, s)
        out = torch.empty(cur.shape, dtype=cur.dtype, device=cur.device)
        groups = out.view(out.shape[0], m // ns, radix, ns, *out.shape[2:])
        for r in range(radix):
            groups[:, :, r] = v[r].reshape(v[r].shape[0], m // ns, ns, *v[r].shape[2:])
        cur = out
        ns *= radix
    return (conj_pairs(cur) if adjoint else cur) * scale


def cluster_chain_reference(x: torch.Tensor, radices: Sequence[int], clusters: int,
                            tables: Dict[str, torch.Tensor],
                            adjoint: bool = False) -> torch.Tensor:
    """The cluster design's schedule (``csrc/cluster.cuh``) in plain torch,
    along axis 1 of float32 ``x`` (units, N, ..., 2): the first pass (radix
    R0 = ``radices[0]``, no twiddle) on butterflies j of rows j + r * N / R0,
    its output q landed in the points of the CTA of ``clusters`` that owns
    class q (CTA c: classes [c R0 / C, (c + 1) R0 / C), Q_c of them, at
    local position (q - lo) + Q_c j); on each CTA's Q_c * N / R0 points the
    later passes as a Stockham chain of local stride ns_l = Q_c ns / R0 with
    the ``cw`` entry of the chain's k = lo + (k_l mod Q_c) + R0 (k_l div
    Q_c); local point i stored at row lo + (i mod Q_c) + R0 (i div Q_c),
    scaled by ``cp[0]``.  ``adjoint`` conjugates on the first load and the
    last store.  Equal to ``radix_chain_reference`` on the same chain (the
    same twiddles, butterflies and order of operations), which the tests
    hold; a test aid that no plan path calls.  Returns a new tensor of x's
    shape."""
    n = x.shape[1]
    if math.prod(radices) != n or len(radices) < 2 or radices[0] < 2 * clusters:
        raise ValueError(f"cluster_chain_reference: radices {tuple(radices)} over "
                         f"{clusters} CTAs do not run {n}")
    tw = tables["cw"]
    scale, s = float(tables["cp"][0]), float(tables["cp"][1])
    ride = (1,) * (x.dim() - 3) + (2,)
    units, rest = x.shape[0], x.shape[2:]
    cur = conj_pairs(x) if adjoint else x
    r0 = radices[0]
    m0 = n // r0
    first = _butterfly([cur[:, r * m0:(r + 1) * m0] for r in range(r0)], s)
    out = torch.empty(cur.shape, dtype=cur.dtype, device=cur.device)
    rows = out.view(units, m0, r0, *rest)          # row q + R0 * j
    for c in range(clusters):
        lo, hi = c * r0 // clusters, (c + 1) * r0 // clusters
        q = hi - lo
        local = torch.stack(first[lo:hi], dim=2).reshape(units, q * m0, *rest)
        ns, gns = q, r0
        for radix in radices[1:]:
            m = q * m0 // radix
            v = [local[:, r * m:(r + 1) * m] for r in range(radix)]
            kl = torch.arange(ns, device=x.device)
            k = lo + kl % q + r0 * (kl // q)
            for r in range(1, radix):
                w = tw[gns - 1 + (r - 1) * gns + k].repeat(m // ns, 1).reshape(1, m, *ride)
                wr, wi = w[..., 0], w[..., 1]
                vr, vi = v[r][..., 0], v[r][..., 1]
                v[r] = torch.stack([vr * wr - vi * wi, vr * wi + vi * wr], dim=-1)
            v = _butterfly(v, s)
            nxt = torch.empty(local.shape, dtype=local.dtype, device=local.device)
            groups = nxt.view(units, m // ns, radix, ns, *rest)
            for r in range(radix):
                groups[:, :, r] = v[r].reshape(units, m // ns, ns, *rest)
            local = nxt
            ns *= radix
            gns *= radix
        rows[:, :, lo:hi] = local.view(units, m0, q, *rest)
    return (conj_pairs(out) if adjoint else out) * scale
