"""Device time a summary spends in ``models.ensemble.ensemble_member_fields``
(the pipeline kernel once per member and the member stack), ms."""

from benchmark.metrics._common import span_ms


def read(run):
    total = span_ms(run, "member_fields")
    return None if total is None else total / len(run.spans["member_fields"])
