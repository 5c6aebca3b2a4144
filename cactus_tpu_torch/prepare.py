"""cactus-prepare equivalent: decomposed stage plans + WDL export.

The reference's cactus-prepare (progressive/cactus_prepare.py:74-99)
decomposes an alignment into independently runnable/restartable stages
(preprocess → per-ancestor blast+align → halAppend) and can print them
as a shell script, run them Toil-in-Toil, or emit a WDL workflow for
Cromwell/Terra.  Here the same three surfaces: `make_plan` builds the
stage DAG, `write_script` prints the ordered commands (the store makes
each stage restartable — `align --target` computes exactly one
ancestor, resuming its dependencies from checkpoints), and `write_wdl`
emits a WDL 1.0 workflow with the same dependency edges, per-stage
memory/cpu/disk from the reference's consolidated resource model
(cactus_prepare.py:349 wdl_disk, cactus_workflow.py:34-97), and File
plumbing for the seqfile + staged upstream artifacts.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .utils.trees import Tree


@dataclass
class Stage:
    name: str
    command: str
    deps: list[str] = field(default_factory=list)
    mem_gb: int = 4
    cpu: int = 2
    disk_gb: int = 8


def _stage_resources(seq_bytes: int | None, cores: int) -> tuple[int, int]:
    """(mem GiB, disk GiB) from the reference's consolidated model."""
    from .utils.resources import estimate_consolidated_memory, estimate_disk
    if not seq_bytes:
        return 4, 8
    mem = estimate_consolidated_memory(seq_bytes, cores=cores)
    disk = estimate_disk(seq_bytes)
    return max(1, -(-mem // (1 << 30))), max(1, -(-disk // (1 << 30)))


def make_plan(tree: Tree, seqfile: str, outdir: str,
              prog: str = "python -m cactus_tpu",
              event_bytes: dict[str, int] | None = None,
              cores: int = 4) -> list[Stage]:
    """Stage DAG: preprocess, one align stage per ancestor (postorder),
    final HAL/MAF export.

    event_bytes (leaf event → input FASTA bytes, e.g. from the
    seqfile's files) sizes each ancestor stage with the reference's
    memory model: an ancestor's input is its children (+outgroups), so
    its budget uses the subtree leaf total — matching the reference's
    per-ancestor cactus_cons_with_resources sizing."""
    t = tree.copy()
    t.name_internal_nodes()
    event_bytes = event_bytes or {}
    total_bytes = sum(event_bytes.values()) or None
    mem, disk = _stage_resources(total_bytes, cores)
    stages = [Stage("preprocess",
                    f"{prog} preprocess {seqfile} {outdir}/prep",
                    mem_gb=max(2, mem // 2), cpu=cores,
                    disk_gb=disk)]
    internal = [n for n in t.postorder() if not n.is_leaf()]
    internal_names = {n.name for n in internal}

    def subtree_bytes(node: Tree) -> int | None:
        if not event_bytes:
            return None
        leaves = node.leaf_names()
        known = [event_bytes[l] for l in leaves if l in event_bytes]
        if not known:
            return None
        # children + up to 3 outgroups of comparable size join the step
        mean = sum(known) / len(known)
        return int(mean * (len(node.children) + min(
            3, max(0, len(t.leaf_names()) - len(leaves)))))

    for node in internal:
        deps = ["preprocess"] + [
            f"align_{c.name}" for c in node.children
            if c.name in internal_names]
        sb = subtree_bytes(node)
        mem, disk = _stage_resources(sb, cores)
        stages.append(Stage(
            f"align_{node.name}",
            f"{prog} align {seqfile} {outdir} --target {node.name}",
            deps=deps, mem_gb=mem, cpu=cores, disk_gb=disk))
    root = internal[-1].name if internal else None
    mem, disk = _stage_resources(total_bytes, cores)
    stages.append(Stage(
        "export",
        f"{prog} align {seqfile} {outdir} --maf {outdir}/out.maf "
        f"--hal {outdir}/out.hal",
        deps=[f"align_{root}"] if root else ["preprocess"],
        mem_gb=mem, cpu=cores, disk_gb=disk))
    return stages


def write_script(stages: list[Stage], fh,
                 seq_bytes: int | None = None) -> None:
    """Ordered shell script (dependencies respected by list order);
    each stage is annotated with its resource-model estimate."""
    fh.write("#!/bin/sh\nset -e\n")
    for s in stages:
        note = f" [est. {s.mem_gb} GiB mem, {s.cpu} cpu]"
        if seq_bytes and s.mem_gb == 4:
            from .utils.resources import estimate_consolidated_memory
            gb = estimate_consolidated_memory(seq_bytes) / (1 << 30)
            note = f" [est. memory {gb:.1f} GiB]"
        if s.deps:
            fh.write(f"# {s.name} (after: {', '.join(s.deps)}){note}\n")
        else:
            fh.write(f"# {s.name}{note}\n")
        fh.write(s.command + "\n")


def _wdl_task(s: Stage) -> str:
    """One WDL task: the seqfile rides as a File input, upstream stage
    markers gate scheduling, and runtime carries the resource model
    (the cactus-prepare --wdl pattern: per-task memory/cpu/disk,
    cactus_prepare.py:349)."""
    return (f"task {s.name} {{\n"
            f"  input {{\n"
            f"    File seqfile\n"
            f"    Array[File] upstream = []\n"
            f"    Int mem_gb = {s.mem_gb}\n"
            f"    Int n_cpu = {s.cpu}\n"
            f"    Int disk_gb = {s.disk_gb}\n"
            f"  }}\n"
            f"  command <<<\n"
            f"    set -e\n"
            f"    {s.command}\n"
            f"    echo done > {s.name}.marker\n"
            f"  >>>\n"
            f"  output {{\n"
            f"    File done = \"{s.name}.marker\"\n"
            f"  }}\n"
            f"  runtime {{\n"
            f"    docker: \"cactus-tpu\"\n"
            f"    memory: mem_gb + \" GB\"\n"
            f"    cpu: n_cpu\n"
            f"    disks: \"local-disk \" + disk_gb + \" SSD\"\n"
            f"  }}\n"
            f"}}\n")


def write_wdl(stages: list[Stage], fh,
              workflow_name: str = "cactus_tpu") -> None:
    """WDL 1.0 workflow: one task per stage, dependency edges through
    the upstream file arrays, the seqfile as a workflow File input, and
    per-task resources from the consolidated memory model."""
    fh.write("version 1.0\n\n")
    for s in stages:
        fh.write(_wdl_task(s) + "\n")
    fh.write(f"workflow {workflow_name} {{\n")
    fh.write("  input {\n    File seqfile\n  }\n")
    for s in stages:
        if s.deps:
            ups = ", ".join(f"{d}.done" for d in s.deps)
            fh.write(f"  call {s.name} {{ input: seqfile = seqfile, "
                     f"upstream = [{ups}] }}\n")
        else:
            fh.write(f"  call {s.name} {{ input: seqfile = seqfile }}\n")
    fh.write("  output {\n")
    fh.write(f"    File result = {stages[-1].name}.done\n")
    fh.write("  }\n}\n")
