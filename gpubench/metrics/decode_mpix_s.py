"""decode_mpix_s: megapixels decoded a second, over the whole window: every
frame collected, times the frame's megapixels, over the window's length
(which ends once the last burst is collected and the device is done)."""


def read(rec, metric):
    if rec.loop.window_s <= 0:
        return None
    return rec.loop.frames * rec.mpix / rec.loop.window_s
