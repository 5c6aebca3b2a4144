"""One driver module per engine entry of the port.

A workload file names its driver (`"driver": "banded"`), and the harness
imports gpubench.drivers.<name> and calls its `Driver(config, workload,
device)`.  A driver knows how to:

- `call(spec, pairs)`: send one recorded call to the entry and return
  the answers on the host (the entry returns once its results are
  there);
- `reference(spec, pairs, control)`: the plain reference's answers for
  these pairs (gpubench/reference/), at the configuration's precision or
  at the control's (`control=True`);
- `control(spec, pairs)`: the control's answers in the entry's form (the
  reference one precision below, in the program's place);
- `compare(items)`: the numbers compared, from (spec, pairs, answers,
  reference answers) of the sampled pairs; `checks` names them (the
  traffic file's `checks` gives their limits);
- `work(c, spec, answers)`: per kernel, the (operations, bytes, peak) of
  call c's pairs, for the rooflines;
- `live_cells(c, spec)`: the live cells of call c.

`kernels` maps each kernel name of the metrics to the device function
names it launches; `launch` names the wrapper whose (P, M, band) shapes
give the computed cells; `spans` the program functions a traced run
wraps in spans.
"""
