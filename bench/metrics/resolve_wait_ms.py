"""Mean time from the end of the flush that ran a window query to its
client's resolve (host clock, nothing synchronised): the rest of that
flush, and any flush the client's own ``Ticket.result()`` runs for other
queries before it returns."""


def read(run):
    w = [q["resolve"] - q["end"] for q in run["queries"]
         if q["in_window"] and q.get("end") is not None]
    return 1e3 * sum(w) / len(w) if w else None
