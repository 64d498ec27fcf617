"""Model families: what a configuration's ``"family"`` names.

A family is two modules, which ``spec.family`` finds by the name the
configuration gives:

- ``families/<family>_reference.py``, the yardstick, which imports nothing
  of the program (``tests/test_cardbench_independence.py``):

  - ``inputs(cfg, clients, seed, device)``: the cell's inputs (weights,
    data, the requests) made from ``seed`` on ``device``, as an object
    with ``pool``, the ``clients`` requests the generator sends;
  - ``check(inputs, kept)``: ``{check name: value}`` over the kept ``(pool
    index, answer)`` pairs, against the family's plain reference, from the
    inputs and the answers alone. Each name has its limit in the
    configuration's ``limits``, and the names have to be those: a value
    passes at or below its limit.

- ``families/<family>.py``, the adapter, which holds all that the harness
  knows of the program that serves the family. Its one entry,
  ``serve(cfg, mix, inputs, device)``, sets the program up with the inputs
  and returns an object with ``calls`` (the engine's calls, a
  ``load.Engine``), ``sizes`` (the size of each batch served while
  ``counting`` is true), ``counting``, ``run_fields()`` (the family's own
  numbers for the metric readers, ``spec.Run.fields``) and ``close()``,
  which frees the program's state.

Beside those keys of its own, a configuration of any family gives
``family``, ``tf32`` (the harness sets PyTorch's TF32 switches from it),
``limits``, and ``serving.max_batch`` (the most requests a batch holds;
the pool's size and ``sweep.py``'s rule read it). A family's work counts,
where its metric readers need operations or bytes, go in
``<family>_work.py``, which is yardstick too.

The GCN family's reference module takes its inputs from ``inputs.py`` and
``gen.py`` and its reference from ``reference.py``; its readers take their
work counts from ``work.py``.
"""
