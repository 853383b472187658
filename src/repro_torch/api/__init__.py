"""The port's public lifecycle API (``repro/api``): the step builders and
names the record and serve launchers share.  The ``Workload`` and
``Workspace`` classes come with a later slice (ROADMAP Queue 1, item 7)."""
