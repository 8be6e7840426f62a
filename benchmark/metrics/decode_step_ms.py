"""Wall time of one logical decode step: each engine dispatch of the traced
window (the step timeline's `dur_s`) over the `chunk` packed forwards it
runs, each of which carries every live slot's next token (and, while a
request is admitting, its prefill lanes), in ms."""


def read(run):
    steps = run.get("steps") or []
    if not steps or not run.get("chunk"):
        return None
    return 1e3 * sum(r["dur_s"] for r in steps) / (len(steps) * run["chunk"])
