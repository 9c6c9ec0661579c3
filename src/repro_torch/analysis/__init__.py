"""Step analysis: what a step dispatches (``op_stats``), its roofline
(``roofline``) and the dry run's tables (``report``)."""
