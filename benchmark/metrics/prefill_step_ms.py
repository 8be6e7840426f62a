"""Mean wall time of the engine steps that carried prefill lanes (eager
ragged dispatches), from the step timeline's `dur_s`, in ms."""


def read(run):
    pf = run.get("prefill_steps") or set()
    durs = [r["dur_s"] for r in run.get("steps") or [] if r["step"] in pf]
    if not durs:
        return None
    return 1e3 * sum(durs) / len(durs)
