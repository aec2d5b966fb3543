"""post.sample_ms: milliseconds per measurement of the self time of the
program's span ``yawt/post.sample`` in the traced window: the estimator and jackknife samples of each correlation function (``CorrFunc.sample``); less
the part of it that the program's spans inside it cover."""

from harness import program_spans


def read(run):
    return program_spans.self_ms(run, "post.sample")
