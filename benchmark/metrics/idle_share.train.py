"""Share of the traced window in which no operation ran on the card:
1 - (union of the device records' intervals) / window, in %."""


def read(run):
    if not run.get("window_s"):
        return None
    return 100.0 * (1.0 - run["busy_s"] / run["window_s"])
