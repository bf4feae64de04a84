"""The port's example scripts, one for each of ``examples/``.

Each runs on the GPU by default, as a module::

    python -m eryn_tpu_torch.examples.basic_gaussian

and exposes ``main(device=None, scale=1.0)`` (``runtime_plots`` also takes
``outdir=``): ``device="cpu"`` runs it on the CPU, and ``scale`` multiplies
its step counts (its statistical assertions run only at ``scale=1.0``).
``main`` prints the script's summary and returns its numbers as a dict.

* ``basic_gaussian``: a 5-D Gaussian with the default stretch move;
* ``custom_moves``: one proposal written for the host (``get_proposal`` on
  NumPy, run eagerly) and in the graph (``get_proposal_kernel`` on
  tensors, captured), and their rates;
* ``gradient_moves``: stretch, MALA, HMC and ChEES-HMC on a 24-D correlated
  Gaussian;
* ``multibranch_search``: two model families with unknown counts under
  reversible jump;
* ``nonreversible_pt``: the swap cascade against DEO swaps, replica round
  trips through a supplemental tag;
* ``pt_evidence``: stepping-stone and thermodynamic evidence on a fixed
  ladder;
* ``rj_pulse_search``: how many Gaussian pulses the data holds;
* ``runtime_plots``: ``PlotContainer``'s plot groups for a tempered run and
  an RJ run (needs matplotlib).
"""

EXAMPLES = ("basic_gaussian", "custom_moves", "gradient_moves",
            "multibranch_search", "nonreversible_pt", "pt_evidence",
            "rj_pulse_search", "runtime_plots")
