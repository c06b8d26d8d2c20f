"""The drivers of the benchmark's cells, one a traffic kind: a mix's ``kind``
names the module here that runs it (``run(run)``)."""
