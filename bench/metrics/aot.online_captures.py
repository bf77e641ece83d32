"""Decode graphs captured inside the window: the AOT graph engine's
``online_compiles`` counter at the window's end less at its start.  Every
bucket the run can meet is captured in set-up, so a capture here is a
bucket set-up did not foresee, paid on the hot path."""


def read(rec):
    return rec["aot_online_window"]
