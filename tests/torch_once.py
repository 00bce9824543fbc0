"""Work that several port tests share, done once per test run: under
``pytest-xdist`` the workers of one run share the directory and the first
to arrive does the work under a file lock; without it, the session's own
temporary directory."""
import fcntl
import os


def once(tmp_path_factory, name: str, build) -> str:
    """The directory ``build(directory)`` filled, once per run."""
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    base = tmp_path_factory.getbasetemp()
    root = str(base.parent / f"{name}-{uid}" if uid else base / name)
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.exists(os.path.join(root, ".done")):
                build(root)
                open(os.path.join(root, ".done"), "w").close()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return root
