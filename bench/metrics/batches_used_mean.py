"""Mean ``QueryAnswer.batches_used`` of the window's queries: the sample
batches a query read before its bound met the target."""


def read(run):
    b = [q["batches_used"] for q in run["queries"]
         if q["in_window"] and q["batches_used"] is not None]
    return sum(b) / len(b) if b else None
