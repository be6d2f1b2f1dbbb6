"""One reader an end-to-end metric: ``read(run) -> float or None``, from the host clock."""
