"""Every token of every optimizer step in the window, over the window's
host seconds (the window ends at the end of its last step)."""


def read(run):
    if run.kind != "train" or not run.window_s:
        return None
    return run.counts["tokens"] / run.window_s
