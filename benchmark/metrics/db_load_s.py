"""Seconds of ``CompiledDB.load`` on the configuration's npz in
set-up, by the host clock."""
LAYER = "DB load"
SOURCE = "host_clock"
UNIT = "s"
MOVES = "setup_s"


def read(trace):
    return trace.db_load_s if trace.db_load_s > 0 else None
