"""Tools of the port: measurement scripts run on a CUDA card, the 4AA
preprocessing of raw MD files (``process_4aa``) and raw MD files of
synthetic peptides (``synthetic_md``)."""
