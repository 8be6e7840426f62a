"""Mean slots decoding over the engine steps of the traced window (the step
timeline's `live_slots`): the batch a decode step serves."""


def read(run):
    steps = run.get("steps") or []
    if not steps:
        return None
    return sum(r["live_slots"] for r in steps) / len(steps)
