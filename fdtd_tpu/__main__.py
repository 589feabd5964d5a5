from .cli import main
from .compile_cache import enable_compile_cache

enable_compile_cache()
raise SystemExit(main())
