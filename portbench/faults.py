"""Faults planted under the timed path, for the tests and readings of
``correct`` (``control.py``): a session whose output is broken where it
is produced.  The benchmark's own runs never plant one."""
import dataclasses

FAULTS = ("stale", "dropped", "altered")


class FaultySession:
    """``stale``: the previous picture's bytes handed out again (a step
    that returns its state unchanged); ``dropped``: every second picture
    left out; ``altered``: one byte of every 8th picture flipped."""

    def __init__(self, ses, fault):
        if fault not in FAULTS:
            raise ValueError("no fault %r" % fault)
        self.ses = ses
        self.fault = fault
        self.prev = None
        self.count = 0

    def decode_nal(self, nal):
        self.ses.decode_nal(nal)

    def flush(self):
        self.ses.flush()

    def get_picture(self):
        while True:
            pic = self.ses.get_picture()
            if pic is None:
                return None
            self.count += 1
            if self.fault == "dropped" and self.count % 2 == 0:
                continue
            break
        if self.fault == "stale":
            out = pic if self.prev is None else dataclasses.replace(
                pic, bytes=self.prev.bytes)
            self.prev = pic
            return out
        if self.fault == "altered" and self.count % 8 == 4:
            b = bytearray(pic.bytes)
            b[len(b) // 3] ^= 1
            return dataclasses.replace(pic, bytes=bytes(b))
        return pic
