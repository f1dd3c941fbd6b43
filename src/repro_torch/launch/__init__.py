"""Drivers (mirrors ``repro.launch``): the LM serving and training
drivers, and the dry-run harness of the walk cells (``dryrun``,
``report``)."""
