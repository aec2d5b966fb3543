"""engine.reach_share: the pairs the measurement's counts need (the
reference's pairs in reach, as engine.paircount_roofline reads them) over
the candidate pairs the engine evaluates (the program's counter
``engine.candidate_pairs``: tile pairs times tile size squared), per
measurement of the traced window, in percent."""

from harness import program_spans


def read(run):
    counted = program_spans.window_counters(run)
    if not counted or not run.works or not counted.get("engine.candidate_pairs"):
        return None
    reach = sum(float(work["pairs_in_reach"]) for work in run.works)
    candidates = counted["engine.candidate_pairs"] / program_spans.measurements(run)
    return 100.0 * reach / candidates
