"""(l2, fold) cells per study that the cross validation's float64 host
oracle redid after their float32 device solve failed the escalation rule:
the rise of the program's counter ``qplinear.fit_routes
["cv_escalated_cells"]`` over each traced study (the entry's
``escalated_sites``)."""


def read(run):
    if not run.escalated:
        return None
    return sum(run.escalated) / len(run.escalated)
