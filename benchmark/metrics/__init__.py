"""One reader a metric: ``<metric>.py`` defines ``read(run)``, which returns the number or nothing where the run holds nothing to read."""
