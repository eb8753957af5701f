"""AV1 still pictures: the OBUs and headers, and the tile decoder's call.

An AVIF image item holds one AV1 key frame (or intra-only frame) as a
sequence of OBUs: a sequence header, then a frame (or a frame header and
its tile groups). This module reads the OBU headers and sizes, the
sequence header (reduced still-picture or full, with colour config and
operating points), the uncompressed frame header of an intra frame
(quantizer and delta q, quantizer matrix levels, segmentation, delta
lf, loop filter, CDEF and loop restoration parameters, tx mode, reduced
tx set, intra block copy, film grain) and the tile info (uniform or
explicit spacing) and tile groups, as the AV1 specification (sections
5.3-5.11) lays them out and dav1d reads them.

The tiles themselves are decoded by native code, `csrc/av1.cpp`
(entropy decoding, prediction, dequantization with the quantizer
matrices, reconstruction, the three in-loop filters and dav1d's film
grain synthesis), compiled by g++ at first use into
`rlshaders_tpu_torch/build/` and bound with ctypes, as `j2k_t1.py` binds
its tier-1; a missing compiler or a failed compile raises.
`decode_frame` returns the 8-bit Y, U and V planes.

Superres and bit depths other than 8 raise NotImplementedError naming
the feature; a malformed stream raises ValueError.
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ..accel import native

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "av1.cpp")
CXX_FLAGS = ("-O2", "-shared", "-fPIC")

OBU_SEQUENCE_HEADER, OBU_FRAME_HEADER, OBU_TILE_GROUP, OBU_FRAME = 1, 3, 4, 6
KEY_FRAME, INTER_FRAME, INTRA_ONLY_FRAME, SWITCH_FRAME = 0, 1, 2, 3
SELECT = 2  # SELECT_SCREEN_CONTENT_TOOLS, SELECT_INTEGER_MV
SEG_FEATURE_BITS = (8, 6, 6, 6, 6, 3, 0, 0)
SEG_FEATURE_SIGNED = (1, 1, 1, 1, 1, 0, 0, 0)
SEG_FEATURE_MAX = (255, 63, 63, 63, 63, 7, 0, 0)
# lr_type as coded -> RESTORE_NONE 0, WIENER 1, SGRPROJ 2, SWITCHABLE 3
REMAP_LR_TYPE = (0, 3, 1, 2)
MAX_TILE_WIDTH, MAX_TILE_AREA = 4096, 4096 * 2304
MAX_TILE_COLS = MAX_TILE_ROWS = 64

# The frame parameters handed to the tile decoder, in the order of
# av1.cpp's `FrameHeader` (all int32): name and count.
FIELDS = (
    ("width", 1), ("height", 1), ("ss_x", 1), ("ss_y", 1),
    ("num_planes", 1), ("use_128", 1), ("enable_filter_intra", 1),
    ("enable_intra_edge_filter", 1), ("disable_cdf_update", 1),
    ("allow_screen_content_tools", 1), ("allow_intrabc", 1),
    ("base_q_idx", 1), ("dq_y_dc", 1), ("dq_u_dc", 1), ("dq_u_ac", 1),
    ("dq_v_dc", 1), ("dq_v_ac", 1), ("qm_y", 1), ("qm_u", 1), ("qm_v", 1),
    ("seg_enabled", 1),
    ("seg_feature_enabled", 64), ("seg_feature_data", 64),
    ("seg_id_pre_skip", 1), ("last_active_seg_id", 1),
    ("delta_q_present", 1), ("delta_q_res", 1), ("delta_lf_present", 1),
    ("delta_lf_res", 1), ("delta_lf_multi", 1), ("lf_level", 4),
    ("lf_sharpness", 1), ("lf_delta_enabled", 1), ("lf_ref_deltas", 8),
    ("lf_mode_deltas", 2), ("cdef_damping", 1), ("cdef_bits", 1),
    ("cdef_y_pri", 8), ("cdef_y_sec", 8), ("cdef_uv_pri", 8),
    ("cdef_uv_sec", 8), ("lr_type", 3), ("lr_size", 3), ("tx_mode", 1),
    ("reduced_tx_set", 1), ("tile_cols", 1), ("tile_rows", 1),
    ("tile_cols_log2", 1), ("tile_rows_log2", 1),
    ("mi_col_starts", 65), ("mi_row_starts", 65), ("coded_lossless", 1),
    ("all_lossless", 1), ("matrix_coefficients", 1),
    ("apply_grain", 1), ("grain_seed", 1), ("num_y_points", 1),
    ("y_points", 28), ("chroma_scaling_from_luma", 1), ("num_uv_points", 2),
    ("uv_points", 40), ("scaling_shift", 1), ("ar_coeff_lag", 1),
    ("ar_coeffs_y", 24), ("ar_coeffs_uv", 50), ("ar_coeff_shift", 1),
    ("grain_scale_shift", 1), ("uv_mult", 2), ("uv_luma_mult", 2),
    ("uv_offset", 2), ("overlap_flag", 1), ("clip_to_restricted_range", 1),
)
# the film grain parameters, zero where a frame has none
GRAIN = {name: 0 if n == 1 else [0] * n for name, n in FIELDS[FIELDS.index(
    ("apply_grain", 1)):]}
# TxMode values
ONLY_4X4, TX_MODE_LARGEST, TX_MODE_SELECT = 0, 1, 2


class BitReader:
    """Big-endian bit reader over bytes, with the specification's
    descriptors; reading past the end raises ValueError."""

    def __init__(self, data: bytes, pos: int = 0, end: int | None = None):
        self.data = data
        self.pos = pos * 8
        self.end = len(data) if end is None else end

    def f(self, n: int) -> int:
        x = 0
        for _ in range(n):
            byte = self.pos >> 3
            if byte >= self.end:
                raise ValueError("AV1 header runs past its OBU")
            x = (x << 1) | ((self.data[byte] >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return x

    def su(self, n: int) -> int:
        v = self.f(n)
        m = 1 << (n - 1)
        return v - 2 * m if v & m else v

    def ns(self, n: int) -> int:
        w = n.bit_length()
        m = (1 << w) - n
        v = self.f(w - 1)
        if v < m:
            return v
        return (v << 1) - m + self.f(1)

    def uvlc(self) -> int:
        lz = 0
        while not self.f(1):
            lz += 1
            if lz >= 32:
                return (1 << 32) - 1
        return self.f(lz) + (1 << lz) - 1

    def byte_alignment(self) -> None:
        self.pos = (self.pos + 7) & ~7


def leb128(data: bytes, at: int) -> tuple:
    value = 0
    for i in range(8):
        if at + i >= len(data):
            raise ValueError("AV1 OBU size ends early")
        b = data[at + i]
        value |= (b & 0x7F) << (7 * i)
        if not b & 0x80:
            return value, at + i + 1
    raise ValueError("AV1 OBU size longer than 8 bytes")


def obus(data: bytes):
    """Yield (type, temporal_id, spatial_id, payload start, payload end)."""
    at = 0
    while at < len(data):
        h = data[at]  # dav1d ignores the forbidden bit (not strict)
        typ, ext, has_size = (h >> 3) & 15, (h >> 2) & 1, (h >> 1) & 1
        at += 1
        tid = sid = 0
        if ext:
            if at >= len(data):
                raise ValueError("AV1 OBU extension ends early")
            tid, sid = data[at] >> 5, (data[at] >> 3) & 3
            at += 1
        if has_size:
            size, at = leb128(data, at)
        else:
            size = len(data) - at
        if at + size > len(data):
            raise ValueError("AV1 OBU runs past the end of its data")
        yield typ, tid, sid, at, at + size
        at += size


def _tile_log2(blk: int, target: int) -> int:
    k = 0
    while (blk << k) < target:
        k += 1
    return k


def sequence_header(data: bytes, at: int = 0, end: int | None = None) -> dict:
    r = BitReader(data, at, end)
    s = {"profile": r.f(3), "still_picture": r.f(1), "reduced": r.f(1)}
    if s["profile"] > 2:
        raise ValueError(f"AV1 seq_profile {s['profile']}")
    s["decoder_model_info"] = 0
    s["equal_picture_interval"] = 0
    s["op_idc"] = [0]
    s["decoder_model_op"] = [0]
    s["level0"] = s["tier0"] = 0
    if s["reduced"]:
        s["level0"] = r.f(5)
    else:
        timing = r.f(1)
        if timing:
            r.f(32)
            r.f(32)
            s["equal_picture_interval"] = r.f(1)
            if s["equal_picture_interval"]:
                r.uvlc()
            s["decoder_model_info"] = r.f(1)
            if s["decoder_model_info"]:
                s["buffer_delay_length"] = r.f(5) + 1
                r.f(32)
                s["buffer_removal_time_length"] = r.f(5) + 1
                s["frame_presentation_time_length"] = r.f(5) + 1
        initial_display_delay = r.f(1)
        n_ops = r.f(5) + 1
        s["op_idc"], s["decoder_model_op"] = [], []
        for k in range(n_ops):
            s["op_idc"].append(r.f(12))
            level = r.f(5)
            tier = r.f(1) if level > 7 else 0
            if k == 0:
                s["level0"], s["tier0"] = level, tier
            dm = 0
            if s["decoder_model_info"]:
                dm = r.f(1)
                if dm:
                    n = s["buffer_delay_length"]
                    r.f(n)
                    r.f(n)
                    r.f(1)
            s["decoder_model_op"].append(dm)
            if initial_display_delay and r.f(1):
                r.f(4)
    wbits, hbits = r.f(4) + 1, r.f(4) + 1
    s["wbits"], s["hbits"] = wbits, hbits
    s["max_width"], s["max_height"] = r.f(wbits) + 1, r.f(hbits) + 1
    s["frame_id_numbers"] = 0 if s["reduced"] else r.f(1)
    if s["frame_id_numbers"]:
        s["delta_frame_id_length"] = r.f(4) + 2
        s["frame_id_length"] = r.f(3) + 1 + s["delta_frame_id_length"]
    s["use_128"] = r.f(1)
    s["enable_filter_intra"] = r.f(1)
    s["enable_intra_edge_filter"] = r.f(1)
    s["order_hint_bits"] = 0
    if s["reduced"]:
        s["force_sct"], s["force_integer_mv"] = SELECT, SELECT
    else:
        r.f(4)  # interintra, masked, warped, dual filter
        order_hint = r.f(1)
        if order_hint:
            r.f(2)  # jnt_comp, ref_frame_mvs
        s["force_sct"] = SELECT if r.f(1) else r.f(1)
        if s["force_sct"] > 0:
            s["force_integer_mv"] = SELECT if r.f(1) else r.f(1)
        else:
            s["force_integer_mv"] = SELECT
        if order_hint:
            s["order_hint_bits"] = r.f(3) + 1
    s["enable_superres"] = r.f(1)
    s["enable_cdef"] = r.f(1)
    s["enable_restoration"] = r.f(1)
    # color_config
    high = r.f(1)
    if s["profile"] == 2 and high:
        bit_depth = 12 if r.f(1) else 10
    else:
        bit_depth = 10 if high else 8
    s["bit_depth"] = bit_depth
    mono = 0 if s["profile"] == 1 else r.f(1)
    s["mono"] = mono
    if r.f(1):
        s["cp"], s["tc"], s["mc"] = r.f(8), r.f(8), r.f(8)
    else:
        s["cp"] = s["tc"] = s["mc"] = 2
    s["csp"] = 0
    if mono:
        s["full_range"] = r.f(1)
        s["ss_x"] = s["ss_y"] = 1
        s["separate_uv_delta_q"] = 0
    else:
        if s["cp"] == 1 and s["tc"] == 13 and s["mc"] == 0:
            s["full_range"] = 1
            s["ss_x"] = s["ss_y"] = 0
        else:
            s["full_range"] = r.f(1)
            if s["profile"] == 0:
                s["ss_x"] = s["ss_y"] = 1
            elif s["profile"] == 1:
                s["ss_x"] = s["ss_y"] = 0
            elif bit_depth == 12:
                s["ss_x"] = r.f(1)
                s["ss_y"] = r.f(1) if s["ss_x"] else 0
            else:
                s["ss_x"], s["ss_y"] = 1, 0
            if s["ss_x"] and s["ss_y"]:
                s["csp"] = r.f(2)
        s["separate_uv_delta_q"] = r.f(1)
    s["film_grain_params_present"] = r.f(1)
    r.f(1)  # dav1d reads the trailing one bit, which must lie in the OBU
    return s


def _delta_q(r: BitReader) -> int:
    return r.su(7) if r.f(1) else 0


def frame_header(r: BitReader, s: dict, tid: int = 0, sid: int = 0) -> dict:
    """The uncompressed header of an intra frame; `r` stands at its
    start and is left after it (before byte alignment)."""
    h = {}
    if s["reduced"]:
        frame_type, show_frame, showable = KEY_FRAME, 1, 0
        error_resilient = 1
    else:
        if r.f(1):
            raise ValueError("AV1 still picture starts with "
                             "show_existing_frame")
        frame_type = r.f(2)
        show_frame = r.f(1)
        if (show_frame and s["decoder_model_info"]
                and not s["equal_picture_interval"]):
            r.f(s["frame_presentation_time_length"])
        showable = frame_type != KEY_FRAME if show_frame else r.f(1)
        if frame_type == SWITCH_FRAME or (frame_type == KEY_FRAME
                                          and show_frame):
            error_resilient = 1
        else:
            error_resilient = r.f(1)
    if frame_type not in (KEY_FRAME, INTRA_ONLY_FRAME):
        raise ValueError("AV1 still picture's first frame is not intra")
    h["frame_type"] = frame_type
    h["show_frame"], h["showable"] = show_frame, showable
    h["disable_cdf_update"] = r.f(1)
    sct = r.f(1) if s["force_sct"] == SELECT else s["force_sct"]
    h["allow_screen_content_tools"] = sct
    if sct and s["force_integer_mv"] == SELECT:
        r.f(1)  # force_integer_mv (1 for intra frames whatever it says)
    if s["frame_id_numbers"]:
        r.f(s["frame_id_length"])
    if frame_type == SWITCH_FRAME:
        override = 1
    elif s["reduced"]:
        override = 0
    else:
        override = r.f(1)
    r.f(s["order_hint_bits"])
    # primary_ref_frame is PRIMARY_REF_NONE for intra frames
    if s["decoder_model_info"]:
        if r.f(1):  # buffer_removal_time_present_flag
            for idc, dm in zip(s["op_idc"], s["decoder_model_op"]):
                if dm:
                    in_t = (idc >> tid) & 1
                    in_s = (idc >> (sid + 8)) & 1
                    if idc == 0 or (in_t and in_s):
                        r.f(s["buffer_removal_time_length"])
    if frame_type == INTRA_ONLY_FRAME:
        refresh = r.f(8)
        if refresh == 0xFF:
            raise ValueError("AV1 intra-only frame refreshes every frame")
        if error_resilient and s["order_hint_bits"]:
            for _ in range(8):
                r.f(s["order_hint_bits"])
    # frame_size
    if override:
        w, hh = r.f(s["wbits"]) + 1, r.f(s["hbits"]) + 1
    else:
        w, hh = s["max_width"], s["max_height"]
    if s["enable_superres"] and r.f(1):
        raise NotImplementedError("AV1 superres is not decoded by the port")
    h["width"], h["height"] = w, hh
    mi_cols, mi_rows = 2 * ((w + 7) >> 3), 2 * ((hh + 7) >> 3)
    if r.f(1):  # render_and_frame_size_different
        r.f(16)
        r.f(16)
    h["allow_intrabc"] = r.f(1) if sct else 0
    h["disable_frame_end_update_cdf"] = (
        1 if s["reduced"] or h["disable_cdf_update"] else r.f(1))
    # tile_info
    use_128 = s["use_128"]
    sb_shift = 5 if use_128 else 4
    sb_cols = (mi_cols + (1 << sb_shift) - 1) >> sb_shift
    sb_rows = (mi_rows + (1 << sb_shift) - 1) >> sb_shift
    sb_size = sb_shift + 2
    max_tile_width_sb = MAX_TILE_WIDTH >> sb_size
    max_tile_area_sb = MAX_TILE_AREA >> (2 * sb_size)
    min_log2_cols = _tile_log2(max_tile_width_sb, sb_cols)
    max_log2_cols = _tile_log2(1, min(sb_cols, MAX_TILE_COLS))
    max_log2_rows = _tile_log2(1, min(sb_rows, MAX_TILE_ROWS))
    min_log2_tiles = max(min_log2_cols,
                         _tile_log2(max_tile_area_sb, sb_rows * sb_cols))
    col_starts, row_starts = [], []
    if r.f(1):  # uniform_tile_spacing_flag
        cols_log2 = min_log2_cols
        while cols_log2 < max_log2_cols and r.f(1):
            cols_log2 += 1
        tw = (sb_cols + (1 << cols_log2) - 1) >> cols_log2
        col_starts = [sb << sb_shift for sb in range(0, sb_cols, tw)]
        rows_log2 = max(min_log2_tiles - cols_log2, 0)
        while rows_log2 < max_log2_rows and r.f(1):
            rows_log2 += 1
        th = (sb_rows + (1 << rows_log2) - 1) >> rows_log2
        row_starts = [sb << sb_shift for sb in range(0, sb_rows, th)]
    else:
        widest, start = 0, 0
        while start < sb_cols:
            col_starts.append(start << sb_shift)
            size = r.ns(min(sb_cols - start, max_tile_width_sb)) + 1
            widest = max(widest, size)
            start += size
        cols_log2 = _tile_log2(1, len(col_starts))
        area = sb_rows * sb_cols
        if min_log2_tiles > 0:
            area >>= min_log2_tiles + 1
        max_h = max(area // widest, 1)
        start = 0
        while start < sb_rows:
            row_starts.append(start << sb_shift)
            start += r.ns(min(sb_rows - start, max_h)) + 1
        rows_log2 = _tile_log2(1, len(row_starts))
    if len(col_starts) > MAX_TILE_COLS or len(row_starts) > MAX_TILE_ROWS:
        raise ValueError("AV1 frame has too many tiles")
    h["tile_cols"], h["tile_rows"] = len(col_starts), len(row_starts)
    h["tile_cols_log2"], h["tile_rows_log2"] = cols_log2, rows_log2
    h["mi_col_starts"] = col_starts + [mi_cols]
    h["mi_row_starts"] = row_starts + [mi_rows]
    h["tile_size_bytes"] = 4
    if cols_log2 or rows_log2:
        r.f(rows_log2 + cols_log2)  # context_update_tile_id
        h["tile_size_bytes"] = r.f(2) + 1
    # quantization_params
    h["base_q_idx"] = r.f(8)
    h["dq_y_dc"] = _delta_q(r)
    h["dq_u_dc"] = h["dq_u_ac"] = h["dq_v_dc"] = h["dq_v_ac"] = 0
    if not s["mono"]:
        diff_uv = r.f(1) if s["separate_uv_delta_q"] else 0
        h["dq_u_dc"], h["dq_u_ac"] = _delta_q(r), _delta_q(r)
        if diff_uv:
            h["dq_v_dc"], h["dq_v_ac"] = _delta_q(r), _delta_q(r)
        else:
            h["dq_v_dc"], h["dq_v_ac"] = h["dq_u_dc"], h["dq_u_ac"]
    # quantizer matrix levels; 15 is flat (no matrix)
    h["qm_y"] = h["qm_u"] = h["qm_v"] = 15
    if r.f(1):  # using_qmatrix
        h["qm_y"], h["qm_u"] = r.f(4), r.f(4)
        h["qm_v"] = r.f(4) if s["separate_uv_delta_q"] else h["qm_u"]
    # segmentation_params
    en = [0] * 64
    data = [0] * 64
    h["seg_enabled"] = r.f(1)
    if h["seg_enabled"]:
        for i in range(8):
            for j in range(8):
                if r.f(1):
                    en[i * 8 + j] = 1
                    bits, lim = SEG_FEATURE_BITS[j], SEG_FEATURE_MAX[j]
                    if SEG_FEATURE_SIGNED[j]:
                        v = max(-lim, min(lim, r.su(1 + bits)))
                    else:
                        v = max(0, min(lim, r.f(bits)))
                    data[i * 8 + j] = v
    h["seg_feature_enabled"], h["seg_feature_data"] = en, data
    h["seg_id_pre_skip"] = int(any(en[i * 8 + j] for i in range(8)
                                   for j in range(5, 8)))
    h["last_active_seg_id"] = max(
        [i for i in range(8) if any(en[i * 8:i * 8 + 8])], default=0)
    # delta_q_params, delta_lf_params
    h["delta_q_present"] = r.f(1) if h["base_q_idx"] > 0 else 0
    h["delta_q_res"] = r.f(2) if h["delta_q_present"] else 0
    h["delta_lf_present"] = h["delta_lf_res"] = h["delta_lf_multi"] = 0
    if h["delta_q_present"]:
        if not h["allow_intrabc"]:
            h["delta_lf_present"] = r.f(1)
        if h["delta_lf_present"]:
            h["delta_lf_res"] = r.f(2)
            h["delta_lf_multi"] = r.f(1)
    coded_lossless = 1
    for seg in range(8):
        q = h["base_q_idx"]
        if h["seg_enabled"] and en[seg * 8]:
            q = max(0, min(255, q + data[seg * 8]))
        if not (q == 0 and h["dq_y_dc"] == 0 and h["dq_u_ac"] == 0
                and h["dq_u_dc"] == 0 and h["dq_v_ac"] == 0
                and h["dq_v_dc"] == 0):
            coded_lossless = 0
    h["coded_lossless"] = h["all_lossless"] = coded_lossless
    # loop_filter_params
    h["lf_level"] = [0, 0, 0, 0]
    h["lf_sharpness"] = 0
    h["lf_delta_enabled"] = 0
    h["lf_ref_deltas"] = [1, 0, 0, 0, -1, 0, -1, -1]
    h["lf_mode_deltas"] = [0, 0]
    if not (coded_lossless or h["allow_intrabc"]):
        h["lf_level"][0], h["lf_level"][1] = r.f(6), r.f(6)
        if not s["mono"] and (h["lf_level"][0] or h["lf_level"][1]):
            h["lf_level"][2], h["lf_level"][3] = r.f(6), r.f(6)
        h["lf_sharpness"] = r.f(3)
        h["lf_delta_enabled"] = r.f(1)
        if h["lf_delta_enabled"] and r.f(1):
            for i in range(8):
                if r.f(1):
                    h["lf_ref_deltas"][i] = r.su(7)
            for i in range(2):
                if r.f(1):
                    h["lf_mode_deltas"][i] = r.su(7)
    # cdef_params
    h["cdef_damping"], h["cdef_bits"] = 3, 0
    h["cdef_y_pri"], h["cdef_y_sec"] = [0] * 8, [0] * 8
    h["cdef_uv_pri"], h["cdef_uv_sec"] = [0] * 8, [0] * 8
    h["cdef_on"] = 0
    if not (coded_lossless or h["allow_intrabc"]) and s["enable_cdef"]:
        h["cdef_on"] = 1
        h["cdef_damping"] = r.f(2) + 3
        h["cdef_bits"] = r.f(2)
        for i in range(1 << h["cdef_bits"]):
            h["cdef_y_pri"][i] = r.f(4)
            sec = r.f(2)
            h["cdef_y_sec"][i] = sec + (sec == 3)
            if not s["mono"]:
                h["cdef_uv_pri"][i] = r.f(4)
                sec = r.f(2)
                h["cdef_uv_sec"][i] = sec + (sec == 3)
    # lr_params
    h["lr_type"], h["lr_size"] = [0, 0, 0], [256, 256, 256]
    if not (h["all_lossless"] or h["allow_intrabc"]) and \
            s["enable_restoration"]:
        planes = 1 if s["mono"] else 3
        uses = chroma = 0
        for i in range(planes):
            t = REMAP_LR_TYPE[r.f(2)]
            h["lr_type"][i] = t
            if t:
                uses = 1
                chroma |= i > 0
        if uses:
            if use_128:
                shift = r.f(1) + 1
            else:
                shift = r.f(1)
                if shift:
                    shift += r.f(1)
            size = 256 >> (2 - shift)
            uv_shift = r.f(1) if s["ss_x"] and s["ss_y"] and chroma else 0
            h["lr_size"] = [size, size >> uv_shift, size >> uv_shift]
    if not h["cdef_on"]:
        h["cdef_damping"] = 0  # the tile decoder reads no cdef_idx
    # read_tx_mode
    if coded_lossless:
        h["tx_mode"] = ONLY_4X4
    else:
        h["tx_mode"] = TX_MODE_SELECT if r.f(1) else TX_MODE_LARGEST
    h["reduced_tx_set"] = r.f(1)
    h.update(GRAIN)
    if s["film_grain_params_present"] and (show_frame or showable) and \
            r.f(1):
        h.update(film_grain_params(r, s))
    return h


def film_grain_params(r: BitReader, s: dict) -> dict:
    """film_grain_params (5.9.30) of an intra frame with apply_grain set
    (update_grain is 1), with dav1d's checks: at most 14 luma and 10
    chroma scaling points in increasing order, and both or neither chroma
    plane scaled at 4:2:0."""
    g = {"apply_grain": 1, "grain_seed": r.f(16)}

    def points(most):
        n = r.f(4)
        if n > most:
            raise ValueError("AV1 film grain has too many scaling points")
        pts = []
        for i in range(n):
            x = r.f(8)
            if i and pts[-1][0] >= x:
                raise ValueError("AV1 film grain scaling points out of order")
            pts.append((x, r.f(8)))
        return n, [v for p in pts for v in p]

    g["num_y_points"], g["y_points"] = points(14)
    csfl = 0 if s["mono"] else r.f(1)
    g["chroma_scaling_from_luma"] = csfl
    n_uv, uv = [0, 0], [[], []]
    if not (s["mono"] or csfl or (s["ss_x"] and s["ss_y"]
                                  and not g["num_y_points"])):
        for pl in range(2):
            n_uv[pl], uv[pl] = points(10)
    if s["ss_x"] and s["ss_y"] and bool(n_uv[0]) != bool(n_uv[1]):
        raise ValueError("AV1 film grain scales one chroma plane of 4:2:0")
    g["num_uv_points"] = n_uv
    g["uv_points"] = (uv[0] + [0] * 20)[:20] + uv[1]
    g["scaling_shift"] = r.f(2) + 8
    lag = g["ar_coeff_lag"] = r.f(2)
    n_pos = 2 * lag * (lag + 1)
    if g["num_y_points"]:
        g["ar_coeffs_y"] = [r.f(8) - 128 for _ in range(n_pos)]
    coeffs_uv = [[0] * 25, [0] * 25]
    for pl in range(2):
        if n_uv[pl] or csfl:
            n = n_pos + (1 if g["num_y_points"] else 0)
            coeffs_uv[pl][:n] = [r.f(8) - 128 for _ in range(n)]
    g["ar_coeffs_uv"] = coeffs_uv[0] + coeffs_uv[1]
    g["ar_coeff_shift"] = r.f(2) + 6
    g["grain_scale_shift"] = r.f(2)
    g["uv_mult"], g["uv_luma_mult"], g["uv_offset"] = [0, 0], [0, 0], [0, 0]
    for pl in range(2):
        if n_uv[pl]:
            g["uv_mult"][pl] = r.f(8) - 128
            g["uv_luma_mult"][pl] = r.f(8) - 128
            g["uv_offset"][pl] = r.f(9) - 256
    g["overlap_flag"] = r.f(1)
    g["clip_to_restricted_range"] = r.f(1)
    return g


def parse(data: bytes, seq: dict | None = None) -> tuple:
    """(sequence header, frame header, tiles) of an AV1 still picture:
    its first frame, read from its OBUs as dav1d reads them (OBUs of
    other operating points than the first dropped, metadata, padding and
    temporal delimiters skipped). A tile is (start, size) in `data`.
    `seq` is the sequence header a decoder already holds (that of an
    earlier image it decoded), which the data's own replaces."""
    frame = None
    tiles = []
    n_tiles = 0
    units = list(obus(data))
    rest = []
    for k, (typ, tid, sid, at, end) in enumerate(units):
        rest = units[k + 1:]
        if typ == OBU_SEQUENCE_HEADER:
            if frame is None:
                seq = sequence_header(data, at, end)
            continue
        if typ not in (OBU_FRAME_HEADER, OBU_FRAME, OBU_TILE_GROUP):
            continue
        if seq is None:
            raise ValueError("AV1 frame before a sequence header")
        idc = seq["op_idc"][0]
        if idc and not ((idc >> tid) & 1 and (idc >> (sid + 8)) & 1):
            continue
        r = BitReader(data, at, end)
        if typ in (OBU_FRAME_HEADER, OBU_FRAME):
            if frame is not None:
                if typ == OBU_FRAME_HEADER:
                    continue  # a redundant copy
                raise ValueError("AV1 still picture holds a second frame")
            frame = frame_header(r, seq, tid, sid)
            n_tiles = frame["tile_cols"] * frame["tile_rows"]
            if typ == OBU_FRAME_HEADER:
                continue
            r.byte_alignment()
        elif frame is None:
            raise ValueError("AV1 tile group before a frame header")
        # tile_group_obu
        start, last = 0, n_tiles - 1
        if n_tiles > 1 and r.f(1):
            bits = frame["tile_cols_log2"] + frame["tile_rows_log2"]
            start, last = r.f(bits), r.f(bits)
        r.byte_alignment()
        if start != len(tiles) or last < start or last >= n_tiles:
            raise ValueError("AV1 tile group out of order")
        pos = r.pos >> 3
        for num in range(start, last + 1):
            if num == last:
                size = end - pos
            else:
                nb = frame["tile_size_bytes"]
                if pos + nb > end:
                    raise ValueError("AV1 tile size ends early")
                size = int.from_bytes(data[pos:pos + nb], "little") + 1
                pos += nb
            if size <= 0 or pos + size > end:
                raise ValueError("AV1 tile runs past its tile group")
            tiles.append((pos, size))
            pos += size
        if len(tiles) == n_tiles:
            break
    # dav1d goes on through the OBUs after the frame: each must be framed
    # right, and a sequence header must parse
    for typ, tid, sid, at, end in rest:
        if typ == OBU_SEQUENCE_HEADER:
            sequence_header(data, at, end)
    if seq is None or frame is None:
        raise ValueError("AV1 data holds no frame")
    if len(tiles) != n_tiles:
        raise ValueError("AV1 frame lacks tiles")
    if seq["bit_depth"] != 8:
        raise NotImplementedError(
            f"AV1 {seq['bit_depth']}-bit samples are not decoded by the "
            f"port")
    return seq, frame, tiles


_lib = None
_lock = threading.Lock()


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(native.build(CXX_FLAGS, SOURCE, "librls_av1"))
            lib.rls_av1_decode.restype = ctypes.c_int
            lib.rls_av1_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p]
            lib.rls_av1_census_size.restype = ctypes.c_int
            lib.rls_av1_yuv_rgb.restype = None
            lib.rls_av1_yuv_rgb.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p]
            lib.rls_av1_unattenuate.restype = None
            lib.rls_av1_unattenuate.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
            _lib = lib
    return _lib


def yuv_rgb(y, u, v, ss_x: int, ss_y: int, consts) -> np.ndarray:
    """(H, W, 3) uint8: libyuv's fixed-point conversion of 8-bit planes
    (grey when u is None), run by the native library."""
    lib = _lib or _load()
    h, w = y.shape
    y = np.ascontiguousarray(y)
    out = np.empty((h, w, 3), np.uint8)
    k = np.asarray(consts, np.int32)
    uc = None if u is None else np.ascontiguousarray(u)
    vc = None if v is None else np.ascontiguousarray(v)
    lib.rls_av1_yuv_rgb(y.ctypes.data, None if uc is None else uc.ctypes.data,
                        None if vc is None else vc.ctypes.data, w, h, ss_x,
                        ss_y, k.ctypes.data, out.ctypes.data)
    return out


def unattenuate(rgb: np.ndarray, a: np.ndarray) -> np.ndarray:
    """libyuv's ARGBUnattenuate of (H, W, 3) uint8 by an 8-bit alpha."""
    lib = _lib or _load()
    rgb = np.ascontiguousarray(rgb).copy()
    a = np.ascontiguousarray(a, np.uint8)
    lib.rls_av1_unattenuate(rgb.ctypes.data, a.ctypes.data, a.size)
    return rgb


def census_names() -> list:
    """The names of the tool counters `decode_frame` adds to."""
    lib = _lib or _load()
    n = lib.rls_av1_census_size()
    get = lib.rls_av1_census_name
    get.restype = ctypes.c_char_p
    get.argtypes = [ctypes.c_int]
    return [get(i).decode() for i in range(n)]


def header_array(seq: dict, frame: dict) -> np.ndarray:
    vals = dict(frame)
    vals["ss_x"], vals["ss_y"] = seq["ss_x"], seq["ss_y"]
    vals["num_planes"] = 1 if seq["mono"] else 3
    vals["use_128"] = seq["use_128"]
    vals["enable_filter_intra"] = seq["enable_filter_intra"]
    vals["enable_intra_edge_filter"] = seq["enable_intra_edge_filter"]
    vals["matrix_coefficients"] = seq["mc"]
    out = []
    for name, n in FIELDS:
        v = vals[name]
        v = list(v) if isinstance(v, (list, tuple)) else [v]
        out += (v + [0] * n)[:n]
    return np.array(out, np.int32)


def decode_frame(data: bytes, census: np.ndarray | None = None,
                 seq: dict | None = None) -> tuple:
    """(seq, Y, U, V) of an AV1 still picture: uint8 planes, U and V at
    the chroma size (None for 4:0:0). `census`, an int64 array of
    `len(census_names())`, gets the counts of the coding tools used;
    `seq` is the decoder's sequence header from an earlier image."""
    seq, frame, tiles = parse(data, seq)
    w, h = frame["width"], frame["height"]
    if w * h > 1 << 28:
        raise ValueError(f"AV1 frame of {w}x{h} is too large")
    hdr = header_array(seq, frame)
    tile_arr = np.array(tiles, np.int32).reshape(-1, 2)
    lib = _lib or _load()
    y = np.zeros((h, w), np.uint8)
    cw, ch = (w + seq["ss_x"]) >> seq["ss_x"], (h + seq["ss_y"]) >> seq["ss_y"]
    mono = seq["mono"]
    u = None if mono else np.zeros((ch, cw), np.uint8)
    v = None if mono else np.zeros((ch, cw), np.uint8)
    n = lib.rls_av1_census_size()
    cen = np.zeros(n, np.int64)
    rc = lib.rls_av1_decode(
        bytes(data), hdr.ctypes.data, tile_arr.ctypes.data, len(tiles),
        y.ctypes.data, None if mono else u.ctypes.data,
        None if mono else v.ctypes.data, cen.ctypes.data)
    if rc != 0:
        raise ValueError(f"AV1 tile data is malformed (code {rc})")
    if census is not None:
        census += cen
    return seq, y, u, v
