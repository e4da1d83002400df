"""Whole-system tools of the port (counterparts of the reference's
``tools/``), each run as ``python -m chore_tpu_torch.tools.<name>``:

* ``e2e_synthetic``: preprocess -> train -> fit -> evaluate on synthetic
  scenes with known ground truth (the learning check);
* ``diag_object``: the object pipeline measured stage by stage on the same
  scenes;
* ``cli_e2e``: the four CLIs chained as subprocesses on a synthetic
  BEHAVE tree;
* ``sil_convergence``: the silhouette phase's recovery basin on a
  4,608-face chair;
* ``make_example``: the synthetic demo folder;
* ``import_torch``: a reference ``checkpoint_*.tar`` -> an experiment
  directory.

Each takes ``--device`` (the card unless ``--device cpu``)."""
