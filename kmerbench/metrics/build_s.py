"""build_s (s, host clock): the facade's build of the index from the
reads and the first query (which builds the query tables: the dense total
table, the sparse engine's bucketed records), synchronised."""


def read(run):
    return run.build_s if run.build_s > 0 else None
