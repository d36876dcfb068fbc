"""Implicit L0/L1 reference list derivation from the picture buffer.

Behavioral equivalent of the reference sorter
(ref: src/xvc_common_lib/reference_list_sorter.h:36-295).  Works for both
decoder and encoder picture objects; `pic_buffer` items must expose
.pic_data (PictureData), .rec_pic and optionally .orig_pic /
.get_alternative_rec_pic().
"""
from .. import constants as k

_MAX_POC = 1 << 62


class ReferenceListSorter:
    def __init__(self, segment_header, prev_segment_open_gop,
                 restrictions=None):
        self.sh = segment_header
        self.prev_open_gop = prev_segment_open_gop
        self.restr = restrictions or segment_header.restrictions

    def prepare(self, curr_poc, curr_tid, is_intra_pic, pic_buffer, rpl,
                leading_pictures=0):
        deps = []
        if rpl is not None:
            rpl.reset(curr_poc)
        if is_intra_pic:
            return deps
        if self.sh.low_delay:
            num_l0 = self._fill_prev_poc(0, 0, curr_poc, pic_buffer, deps,
                                         rpl)
            self._fill_lower_poc(0, num_l0, curr_poc, 0, pic_buffer, deps,
                                 rpl)
            num_l1 = self._fill_prev_poc(1, 0, curr_poc, pic_buffer, deps,
                                         rpl)
            self._fill_lower_poc(1, num_l1, curr_poc, 0, pic_buffer, deps,
                                 rpl)
            return deps
        if self.restr.disable_inter_bipred:
            self._fill_closest_poc(0, 0, curr_poc, curr_tid, pic_buffer,
                                   deps, rpl)
            return deps
        num_l0 = self._fill_lower_poc(0, 0, curr_poc, curr_tid, pic_buffer,
                                      deps, rpl)
        if self.restr.disable_ext_ref_list_l0_trim or num_l0 == 0:
            self._fill_higher_poc(0, num_l0, curr_poc, curr_tid, pic_buffer,
                                  deps, rpl)
        num_l1 = self._fill_higher_poc(1, 0, curr_poc, curr_tid, pic_buffer,
                                       deps, rpl)
        self._fill_lower_poc(1, num_l1, curr_poc, curr_tid, pic_buffer,
                             deps, rpl)
        return deps

    def _same_or_prev_segment(self, pd):
        return pd.soc == self.sh.soc or \
            (pd.soc == (self.sh.soc + 1) % 256 and self.prev_open_gop)

    def _is_same_dimension(self, pd):
        return (self.sh.internal_width == pd.width and
                self.sh.internal_height == pd.height and
                self.sh.chroma_format == pd.chroma_format and
                self.sh.internal_bitdepth == pd.bitdepth)

    def _set(self, rpl, ref_list, ref_idx, pic, alt=False):
        if rpl is None:
            return
        rec = pic.rec_pic
        if alt:
            rec = pic.get_alternative_rec_pic(self.sh)
        rpl.set_ref_pic(ref_list, ref_idx, pic.pic_data.poc, pic.pic_data,
                        rec, getattr(pic, "orig_pic", None))

    def _fill_lower_poc(self, ref_list, start_idx, curr_poc, curr_tid,
                        pic_buffer, deps, rpl):
        last_added_poc = curr_poc
        last_added_tid = curr_tid
        ref_idx = start_idx
        while ref_idx < self.sh.num_ref_pics:
            highest_poc_plus1 = 0
            best = None
            for pic in pic_buffer:
                pd = pic.pic_data
                if (not (rpl is not None and
                         rpl.has_ref_poc(ref_list, pd.poc)) and
                        pd.soc == self.sh.soc and
                        pd.poc < last_added_poc and
                        pd.poc + 1 > highest_poc_plus1 and
                        (pd.tid < last_added_tid or pd.tid == 0)):
                    best = pic
                    highest_poc_plus1 = pd.poc + 1
            if best is None:
                break
            last_added_tid = best.pic_data.tid
            last_added_poc = highest_poc_plus1 - 1
            self._set(rpl, ref_list, ref_idx, best)
            deps.append(best)
            ref_idx += 1
        return ref_idx

    def _fill_higher_poc(self, ref_list, start_idx, curr_poc, curr_tid,
                         pic_buffer, deps, rpl):
        last_added_poc = curr_poc
        last_added_tid = curr_tid
        ref_idx = start_idx
        while ref_idx < self.sh.num_ref_pics:
            lowest_poc = _MAX_POC
            best = None
            for pic in pic_buffer:
                pd = pic.pic_data
                if (self._same_or_prev_segment(pd) and
                        pd.poc > last_added_poc and
                        pd.poc < lowest_poc and
                        (pd.tid < last_added_tid or pd.tid == 0)):
                    best = pic
                    lowest_poc = pd.poc
            if best is None:
                break
            last_added_tid = best.pic_data.tid
            last_added_poc = lowest_poc
            alt = (self.sh.soc != best.pic_data.soc and
                   not self._is_same_dimension(best.pic_data))
            self._set(rpl, ref_list, ref_idx, best, alt=alt)
            deps.append(best)
            ref_idx += 1
        return ref_idx

    def _fill_prev_poc(self, ref_list, start_idx, curr_poc, pic_buffer,
                       deps, rpl):
        ref_idx = start_idx
        if ref_idx < self.sh.num_ref_pics:
            best = None
            for pic in pic_buffer:
                if pic.pic_data.poc + 1 == curr_poc:
                    best = pic
            if best is None:
                return ref_idx
            self._set(rpl, ref_list, ref_idx, best)
            deps.append(best)
            ref_idx += 1
        return ref_idx

    def _fill_closest_poc(self, ref_list, start_idx, curr_poc, curr_tid,
                          pic_buffer, deps, rpl):
        last_added_poc0 = curr_poc
        last_added_tid0 = curr_tid
        last_added_poc1 = curr_poc
        last_added_tid1 = curr_tid
        ref_idx = start_idx
        while ref_idx < self.sh.num_ref_pics:
            lowest_poc = _MAX_POC
            highest_poc_plus1 = 0
            best0 = best1 = None
            for pic in pic_buffer:
                pd = pic.pic_data
                if (self._same_or_prev_segment(pd) and
                        pd.poc > last_added_poc1 and
                        pd.poc < lowest_poc and
                        (pd.tid < last_added_tid1 or pd.tid == 0)):
                    best1 = pic
                    lowest_poc = pd.poc
                elif (pd.soc == self.sh.soc and
                      pd.poc < last_added_poc0 and
                      pd.poc + 1 > highest_poc_plus1 and
                      (pd.tid < last_added_tid0 or pd.tid == 0)):
                    best0 = pic
                    highest_poc_plus1 = pd.poc + 1
            if best0 is None and best1 is None:
                break
            if highest_poc_plus1 == 0 or \
                    lowest_poc - curr_poc <= curr_poc - highest_poc_plus1:
                last_added_tid1 = best1.pic_data.tid
                last_added_poc1 = lowest_poc
                alt = (self.sh.soc != best1.pic_data.soc and
                       not self._is_same_dimension(best1.pic_data))
                self._set(rpl, ref_list, ref_idx, best1, alt=alt)
                deps.append(best1)
            else:
                last_added_tid0 = best0.pic_data.tid
                last_added_poc0 = highest_poc_plus1 - 1
                self._set(rpl, ref_list, ref_idx, best0)
                deps.append(best0)
            ref_idx += 1
        return ref_idx
