import sys

if sys.argv[1:2] == ["lint"]:
    # The lint reads source trees only: dispatch it before the command
    # line's imports load torch, so the lint process never does.
    from .analysis import main as lint_main

    sys.exit(lint_main(sys.argv[2:]))

from .cli import main

sys.exit(main())
