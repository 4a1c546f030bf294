"""Peaks of the card and the least time each kernel's work needs.

Copied from ``chip_smoke.py`` (``PEAK_BYTES_S``, ``PEAK_INT32_OPS_S``,
``literal_ops``, ``blockmask_ops``, ``roofline_ms``, ``bound_ms`` and
the resident interval bound), with one change: the secret sieve's
operations here are those that do not depend on the data (every
literal and every chain's first unit tested at every position, the
bitmap logic), because a span tells the segments a launch scanned and
not their bytes. The chains' later units, which the kernel tests only
where the earlier ones held, are left out, so the bound is a lower
bound and a share of it never overstates the kernel.

Peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet):
3.35 TB/s of HBM3. The data sheet gives no INT32 rate; the one here is
derived: 132 SMs × 64 INT32 lanes × 1.98 GHz boost, since the sheet's
67 TFLOP/s of fp32 is 132 × 128 lanes × 2 (FMA) × 1.98 GHz and Hopper
has half as many INT32 lanes as FP32 lanes. A card set below 700 W
runs slower than these peaks; every share is stated beside the card's
power limit.
"""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12                 # data sheet
PEAK_INT32_OPS_S = 132 * 64 * 1.98e9   # derived, see above
PIECE = 32          # bytes of a chain literal per term (4 chunks of 8)
CODE_LEN = 8        # bytes of one literal chunk (two 32-bit words)
# the resident interval match, per row: 17 int32 gathered (16 bounds
# and the flags), the rank and the row index in, one bool out
INTERVAL_ROW_BYTES = 4 * (4 * 4 + 1) + 8 + 1


def roofline_ms(nbytes: float, ops: float) -> tuple:
    """(the least time in ms, "bytes" or "operations"): the larger of
    the bytes over the memory rate and the operations over the INT32
    rate."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_INT32_OPS_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else \
        (t_bytes, "bytes")


def literal_ops(lit: bytes) -> int:
    """Operations of one literal test at one position: per 4-byte half
    of each 8-byte chunk, none where its mask is 0 (always true), one
    compare where the mask is full, a mask AND and a compare otherwise;
    then one AND per further compare."""
    ops = cmps = 0
    for j in range(0, len(lit), CODE_LEN):
        m = len(lit[j:j + CODE_LEN])
        for half in (min(m, 4), max(m - 4, 0)):
            if half:
                cmps += 1
                ops += 1 if half == 4 else 2
    return ops + max(cmps - 1, 0)


def erosion_steps(n: int) -> list:
    """The shift of each log-doubling step of an erosion by n."""
    steps, span = [], 1
    while span < n:
        steps.append(min(span, n - span))
        span += steps[-1]
    return steps


def chain_len(units) -> int:
    return sum(len(u[1]) if u[0] == "lit" else u[2] for u in units)


def sieve_shape(scanner) -> dict:
    """What the sieve's bound needs of a secret scanner's rule table,
    as plain data: its literals, chains (units ``("lit", bytes)`` or
    ``("run", byte set, n)``), run specs (byte set, run length),
    pattern count and kernel descriptor bytes, and the segment
    length."""
    from trivy_tpu_torch.secret.batch import SEG_LEN
    table = scanner.table
    specs = tuple(scanner.plan.run_specs)
    chains = [[("lit", bytes(u[1])) if u[0] == "lit"
               else ("run", u[1], int(u[2])) for u in units]
              for units in table.chains]
    return {"literals": [bytes(x) for x in table.literals],
            "chains": chains,
            "specs": [(s.ranges, int(s.runlen)) for s in specs],
            "n_patterns": int(table.n_patterns),
            "desc_bytes": int(table.kernel_desc(specs).nbytes),
            "seg_len": int(SEG_LEN)}


def sieve_ops(rows: int, shape: dict) -> float:
    """Integer operations the fused sieve needs on ``rows`` segments
    whatever their bytes. Per position: lowering the byte (3) and one
    funnel shift for its window word, and every literal's test and one
    OR into its block bit. Per chain, its first unit: a literal tested
    and ORed wherever it can start. The rest is bit logic on 32-bit
    bitmap words: per byte one class-table read per 32 sets, per set
    and word one ballot; per word a shift and an AND per step of each
    distinct (set, n) erosion, a shift and an AND per chain term, a
    test and an OR per chain, and per run spec the steps of its own
    erosion and one OR."""
    L = shape["seg_len"]
    n = float(rows * L)
    words = n / 32
    chains = shape["chains"]
    chain_eros = {(u[1], u[2]) for units in chains for u in units
                  if u[0] == "run"}
    spec_set = {(r, k) for r, k in shape["specs"]}
    sets = {r for r, _ in chain_eros} | {r for r, _ in spec_set}
    spec_eros = spec_set - chain_eros
    terms = sum(-(-len(u[1]) // PIECE) if u[0] == "lit" else 1
                for units in chains for u in units)
    first = sum(float(rows * (L - chain_len(units) + 1))
                * (literal_ops(units[0][1]) + 1)
                for units in chains if units and units[0][0] == "lit")

    def steps(eros) -> int:
        return sum(len(erosion_steps(k)) for _, k in eros)

    return (4 * n
            + n * sum(literal_ops(lit) + 1 for lit in shape["literals"])
            + n * -(-len(sets) // 32) + words * len(sets)
            + first + words * (2 * steps(chain_eros) + 2 * terms
                               + 2 * len(chains))
            + words * (2 * steps(spec_eros) + len(shape["specs"])))


def sieve_bound_ms(rows: int, shape: dict) -> tuple:
    """(ms, "bytes" or "operations") the fused sieve needs at least on
    ``rows`` segments: the segments and the descriptor in, two bytes
    of block mask per pattern and one byte per run spec out."""
    nbytes = rows * shape["seg_len"] + shape["desc_bytes"] + \
        rows * shape["n_patterns"] * 2 + rows * len(shape["specs"])
    return roofline_ms(nbytes, sieve_ops(rows, shape))


def interval_bound_ms(rows: int) -> tuple:
    """(ms, "bytes") the resident interval match needs at least on
    ``rows`` rows."""
    return roofline_ms(rows * INTERVAL_ROW_BYTES, 0.0)
