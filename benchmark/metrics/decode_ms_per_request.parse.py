"""Host milliseconds a request spends turning backpointers into trees:
the wall time of ``analysis/eval.py:eval_batch_trees``, taken in the
decoding process around each request's decode."""


def read(run):
    n = run.spans.count("decode")
    if run.kind != "parse" or not n:
        return None
    return 1e3 * run.spans.total("decode") / n
