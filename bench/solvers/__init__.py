"""One solve loop per algorithm, found by the name that a traffic file's
``algorithm`` gives (`bench.harness.load_solver`).

A solve loop module defines:

* ``METRIC``: the end-to-end rate it reports, whole window over
  iterations completed;
* ``CONTROL``: the precision of the reference that stands in as the
  control (`bench.reference.cpd.PRECISIONS`);
* ``SPANS``: {span name: (module, attribute)} of the port's entries the
  traced run wraps;
* ``initial(coo, rank, seed, index)``: one solve's starting point, drawn
  on the tensor's device from the run's seed and the solve's index;
* ``solve(port, traffic, init)``: one whole solve through the port;
* ``iterations(result)``: the iterations it completed;
* ``answer(result)``: what it answers, in the reference's form;
* ``bound_s(dims, nnz, distinct, rank, traffic)``: the roofline's least
  time of one iteration's sparse kernels (`bench.roofline`);
* ``reference(coo, traffic, init, precision)``: the plain reference's
  solve from the same start (`bench.reference.cpd`);
* ``compare(coo, out, ref)``: the numbers that decide ``correct`` for
  an answer, each held under the cell's limit of the same name.
"""
