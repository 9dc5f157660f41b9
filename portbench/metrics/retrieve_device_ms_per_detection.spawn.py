"""Device ms a retrieval: the operations between the program's `retrieve`
stage marks in the traced unit, over its `semantic.retrieve` spans (one a
new detection). None where the program marks no such stage."""
from portbench.program_trace import recorder, span_count, stage_split
from portbench.readers import traced


def read(run):
    rec = recorder()
    if rec is None or not traced(run):
        return None
    got = stage_split(run.window.ops, rec.MARKS).get("retrieve")
    n = span_count(run, "semantic.retrieve")
    if got is None or got[0] is None or not n:
        return None
    return got[0] / 1e3 / n
