"""osd_host_share.dem: host seconds inside the decoder's OSD call (the
configuration's ``host_spans`` label ``osd``) over the traced window, in %."""


def read(ctx):
    t = ctx["trace"]
    if not t or "osd" not in t["spans_s"] or t["window_s"] <= 0:
        return None
    return 100.0 * t["spans_s"]["osd"] / t["window_s"]
