"""One driver module per engine entry of the port.

A workload file names its driver (`"driver": "banded"`), and the harness
imports gpubench.drivers.<name> and calls its `Driver(config, workload,
device)`.  A call's problems are the (query, target) pairs, uint8
codes, that gpubench/traffic.py makes of it; a driver of an engine that
takes groups of homologous sequences passes each pair on as a group of
two members.  A driver knows how to:

- `call(spec, pairs)`: send one recorded call to the entry and return
  one answer a pair on the host (the entry returns once its results are
  there).  Answers compare with `==` to a bool, as tuples, lists,
  numbers and strings do (not numpy arrays or objects without value
  equality): the harness keeps an answer only where it differs from
  those kept for the same pair;
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
names it launches; `launch` names the wrapper whose launches give the
computed cells: P x M x band of its first argument's shape (P, M) and
its `band` keyword (harness.launch_cells), or what the driver's own
`launch_cells(args, kwargs)` counts for one call of it, where that
wrapper takes other arguments; `entry_span` the program's span around
the entry (gpubench/program_spans.py; None where the program opens
none); `spans` the program functions a traced run wraps in spans.
"""
