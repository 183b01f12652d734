"""Interactive wizard — the terminal equivalent of the reference's Swing GUI.

The reference auto-generates a parameter form from each tool's declared
ParameterDescriptions and launches matrix-builder (src/GUI.java:27-29,
1089-1096, launched via --gui, src/Runner.java:61-75).  This wizard does
the same from the Tool PARAMS declarations: pick a tool, fill in its
parameters (defaults shown), confirm, run.

Counterpart of metafast_tpu/gui.py (:16-70).  One addition: a
``--device`` given beside ``--gui`` is passed on to the run.
"""

from __future__ import annotations


def run_wizard(argv=None, input_fn=input, print_fn=print) -> int:
    from .tools.framework import all_tools

    argv = list(argv or [])
    launch = []                     # launch options passed on to the run
    if "--device" in argv:
        i = argv.index("--device")
        launch = argv[i:i + 2]
    tools = all_tools()
    names = sorted(tools)
    print_fn("metafast-tpu interactive wizard")
    print_fn("Available tools:")
    for i, name in enumerate(names, 1):
        print_fn(f"  {i:2d}. {name:28s} {tools[name].DESCRIPTION}")
    default_tool = "matrix-builder"
    raw = input_fn(f"Tool [{default_tool}]: ").strip()
    if raw.isdigit() and 1 <= int(raw) <= len(names):
        tool_name = names[int(raw) - 1]
    elif raw:
        tool_name = raw
    else:
        tool_name = default_tool
    if tool_name not in tools:
        print_fn(f"Unknown tool {tool_name!r}")
        return 1

    tool = tools[tool_name]()
    print_fn(f"\n{tool_name}: {tool.DESCRIPTION}")
    print_fn("Enter parameter values (empty keeps the default; "
             "space-separated lists for multi-value).\n")

    args = ["-t", tool_name]
    for p in tool.PARAMS:
        d = ("REQUIRED" if p.mandatory
             else str(p.default_comment or p.default))
        raw = input_fn(f"  --{p.name} [{d}]: ").strip()
        if not raw:
            if p.mandatory:
                print_fn(f"  ! {p.name} is required")
                raw = input_fn(f"  --{p.name} [{d}]: ").strip()
                if not raw:
                    print_fn("aborted")
                    return 1
            else:
                continue
        if p.type is bool:
            if raw.lower() in ("y", "yes", "true", "1"):
                args.append(f"--{p.name}")
        else:
            args.append(f"--{p.name}")
            args.extend(raw.split())

    workdir = input_fn("Working directory [workDir]: ").strip() or "workDir"
    args += ["-w", workdir]
    print_fn("\nCommand: python -m metafast_tpu_torch.cli " + " ".join(args))
    go = input_fn("Run now? [Y/n]: ").strip().lower()
    if go in ("n", "no"):
        return 0
    from .cli import main
    return main(args + launch)
