#!/usr/bin/env python
"""The port's CPU gate: validate a serve-smoke trace against the obs
event schema.

  PYTHONPATH=src python scripts/check_trace_torch.py build/trace.json
  PYTHONPATH=src python scripts/check_trace_torch.py --require-event \\
      cache_hit build/trace.json

The port's counterpart of ``scripts/check_trace.py``: loads the
Chrome/Perfetto trace-event JSON written by ``repro_torch.launch.serve
--trace-out`` and runs ``repro_torch.obs.validate_trace`` requiring at
least one event of every always-present category (request, step,
dispatch, compile, arena — ``fault`` only appears when chaos or
containment fired, so it is validated but not required).
``--require-event NAME`` (repeatable) additionally demands at least one
event with that name: the prefix-cache smoke requires ``cache_hit``, the
chaos smoke ``fault``.  Exits non-zero with the problem list on failure.
"""
import json
import sys


def main(argv=None) -> int:
    argv, require_events = list(sys.argv[1:] if argv is None else argv), []
    while "--require-event" in argv:
        i = argv.index("--require-event")
        if i + 1 >= len(argv):
            print(__doc__)
            return 2
        require_events.append(argv[i + 1])
        del argv[i:i + 2]
    if len(argv) != 1:
        print(__doc__)
        return 2
    from repro_torch.obs import REQUIRED_CATEGORIES, validate_trace

    path = argv[0]
    try:
        doc = json.loads(open(path).read())
    except (OSError, ValueError) as e:
        print(f"check_trace_torch: cannot load {path}: {e}")
        return 1
    errs = validate_trace(doc, require_categories=REQUIRED_CATEGORIES)
    names = {e.get("name") for e in doc.get("traceEvents", [])}
    errs += [f"required event {name!r} absent from trace"
             for name in require_events if name not in names]
    if errs:
        print(f"check_trace_torch: {path} FAILED ({len(errs)} problems):")
        for e in errs:
            print(f"  - {e}")
        return 1
    n = len(doc.get("traceEvents", []))
    cats = sorted({e.get("cat") for e in doc["traceEvents"] if e.get("cat")})
    print(f"check_trace_torch: {path} OK — {n} events, categories: "
          f"{', '.join(cats)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
