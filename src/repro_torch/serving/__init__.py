"""The port's serving plane: the paged inference engine, its KV
manager and the run metrics."""
