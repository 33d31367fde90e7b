#!/usr/bin/env python3
"""Time the train_levels kernel (K11, the level scan of a whole append
train) of one checkout of the PyTorch/CUDA port on one CUDA card, train
by train.

    python3 scripts/time_train_levels.py [--root DIR] [--reps N] [--device cuda|cpu]
                                         [--shapes LABEL,...] [--cache DIR]

As scripts/time_step_levels.py (whose helpers and grid cache it shares),
over a grid's trains of 8,192 events (trains_from_grid, t_cap 832; the
bench cell's 4 trains at bench_incremental.py's constants): apply_deltas,
then the plain version once on a clone and every walk of the checkout's
`_ext.train_levels` that can run the shape --reps times on the kept
fields, each launch held torch.equal to the plain version's state, then
the decide. Shapes: the bench cell's trains (64 validators, wide), the
bench grid's generator at 32, 48 and 96 validators, the switch grid (128,
packed), BASELINE.json config #4 in 8 trains (256, packed) and config #5's
width (1,024 validators, 16,384 events, packed). Prints one JSON line per
shape and walk, as time_step_levels.py does.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from time_step_levels import (  # noqa: E402
    LEVEL_WRITTEN, Timer, cached_grid, forms_of, grid_specs, setup, time_calls)


def train_config(cs, label, g):
    """(e_cap, r_cap, r_win, e_win, upd_cap) of a shape's train path, as
    chip_smoke.py drives it (phases 9, 16(b) and 16(d))."""
    if label == "config #4 state":
        c = cs.FL_WIDE_INC
        return c["e_cap"], c["r_cap"], c["r_win"], c["e_win"], cs.FL_WIDE["upd_cap"]
    if label == "width state":
        return g.e, 32, 32, g.e, 1 << 24
    c = cs.INC_TRAIN
    e_cap = max(c["e_cap"], g.e)
    return e_cap, c["r_cap"], c["r_win"], e_cap, c["upd_cap"]


def main() -> int:
    args, cs, dev, card, wanted = setup(__doc__.split("\n\n")[0])
    from babble_tpu_torch.tpu import _ext
    from babble_tpu_torch.tpu import incremental as inc

    timer = Timer(dev)
    for label, spec, packed in grid_specs(cs):
        if wanted and label not in wanted:
            continue
        g = cached_grid(spec, args.cache)
        sm, n = g.super_majority, g.n
        e_cap, r_cap, r_win, e_win, upd_cap = train_config(cs, label, g)
        size = cs.INC_TRAIN["size"]
        while True:
            try:
                trains = inc.trains_from_grid(g, size, upd_cap, e_cap,
                                              t_cap=cs.INC_TRAIN["t_cap"])
                break
            except ValueError:  # a burst above the cap
                upd_cap *= 2
        xs = [inc.device_put(t, dev) for t in trains]
        st = inc.init_state(n, e_cap, r_cap, device=dev)

        def kern(st, x, form):
            if not timer.cuda:
                inc._train_levels(st, x, sm, packed=packed)
                return
            _ext.train_levels(
                st.fd, st.rounds, st.lamport, st.witness, st.wtable, st.w_of_row, st.la_w,
                st.fd_w, st.idx_w, st.coin_w, st.rounds_decided, st.last_round, st.count,
                st.stale, x.rows, x.creator, x.index, x.sp_row, x.op_row, x.sp_pos, x.op_pos,
                x.la_rows, x.coin, x.fixed_round, x.levels, sm, packed=packed,
                **({} if form is None else {"form": form}))

        _, w = xs[0].levels.shape
        forms = [f for f in forms_of(_ext.train_levels, timer.cuda)
                 if f is None or _ext.train_levels_form_fits(f, n, size, w, r_cap)]
        out, (plain_ms, levels, bound_ms, bound_by) = time_calls(
            cs, label, xs, st, lambda s, x: inc._train_levels_plain(s, x, sm, packed=packed),
            kern, forms, lambda s: inc._decide_body(s, sm, n, r_win=r_win, e_win=e_win,
                                                    packed=packed),
            False, args.reps, timer, written=LEVEL_WRITTEN,
            before=lambda s, x: inc._apply_deltas_and_stage(s, x))
        chosen = (_ext.train_levels_form(n, size, w, r_cap)
                  if hasattr(_ext, "train_levels_form") else None)
        for form, (ms, med, launched, split) in out.items():
            print(json.dumps({
                "kernel": "train_levels", "shape": label, "validators": n, "packed": packed,
                "form": form, "chosen": form is not None and form == chosen,
                "calls": len(xs), "levels_per_call": levels, "launches": launched,
                "ms": ms, "median_ms": med, "reps": args.reps, "split_ms": split,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "root": args.root,
                "card": card}), flush=True)
        del g, trains, xs, st
    return 0


if __name__ == "__main__":
    sys.exit(main())
