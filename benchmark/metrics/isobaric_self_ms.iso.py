"""Device time a step spends in ``models.pipeline.derived_fields_isobaric``
outside its two kernels' launches (the program's ``isobaric.step`` spans
less their ``b2.kernel`` and ``b1.kernel`` children): the glue between
the kernels and any wait of the stream on the host inside the step, ms."""

from benchmark.metrics._program import recording


def read(run):
    rec = recording()
    if rec is None:
        return None
    own = [s.self_ms for s in rec.spans if s.name == "isobaric.step"]
    return sum(own) / run.units if own else None
