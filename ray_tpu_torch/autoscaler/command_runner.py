"""Per-node command execution for cluster bring-up.

Reference: python/ray/autoscaler/_private/command_runner.py — the
``CommandRunnerInterface`` implemented by ``SSHCommandRunner`` (exec on
a remote machine over ssh, file sync over rsync/scp) and a local
subprocess flavor. The updater (updater.py) drives a runner to
bootstrap a node: wait until reachable, sync file mounts, run setup
and start commands.

``SSHCommandRunner`` builds standard ssh/rsync argument vectors; the
process launcher is injectable (``exec_fn``) so the argv contract is
unit-testable on hosts without sshd — and on a real fleet the default
``subprocess.run`` launcher speaks to real machines unchanged.
"""

from __future__ import annotations

import os
import subprocess
from typing import Callable, Dict, List, Optional, Tuple

ExecFn = Callable[[List[str]], Tuple[int, str, str]]


def _default_exec(argv: List[str], timeout: float = 300.0,
                  env: Optional[Dict[str, str]] = None
                  ) -> Tuple[int, str, str]:
    proc = subprocess.run(argv, capture_output=True, text=True,
                          timeout=timeout, env=env)
    return proc.returncode, proc.stdout, proc.stderr


class CommandRunnerInterface:
    """What the NodeUpdater needs from a node (reference
    command_runner.py CommandRunnerInterface)."""

    def run(self, cmd: str, timeout: float = 300.0) -> Tuple[int, str]:
        """Run a shell command on the node; returns (rc, stdout)."""
        raise NotImplementedError

    def run_rsync_up(self, source: str, target: str) -> None:
        """Copy a local path onto the node."""
        raise NotImplementedError

    def run_rsync_down(self, source: str, target: str) -> None:
        """Copy a node path to the local machine."""
        raise NotImplementedError

    def remote_shell_command_str(self) -> str:
        """The command a human would use to reach the node."""
        raise NotImplementedError


class LocalCommandRunner(CommandRunnerInterface):
    """The node IS this machine (reference LocalNodeProvider posture):
    commands run as local shells with the sanitized child env, so
    bring-up never inherits the caller's accelerator hooks."""

    def __init__(self, env: Optional[Dict[str, str]] = None):
        if env is None:
            from ray_tpu_torch.cluster.child_env import sanitized_env

            env = sanitized_env(pin_pythonpath=True)
        self._env = env

    def run(self, cmd: str, timeout: float = 300.0) -> Tuple[int, str]:
        proc = subprocess.run(["/bin/sh", "-c", cmd],
                              capture_output=True, text=True,
                              timeout=timeout, env=self._env)
        return proc.returncode, proc.stdout

    def run_rsync_up(self, source: str, target: str) -> None:
        self._copy(source, target)

    def run_rsync_down(self, source: str, target: str) -> None:
        self._copy(source, target)

    @staticmethod
    def _copy(source: str, target: str) -> None:
        import shutil

        os.makedirs(os.path.dirname(os.path.abspath(target)),
                    exist_ok=True)
        if os.path.isdir(source):
            shutil.copytree(source, target, dirs_exist_ok=True)
        else:
            shutil.copy2(source, target)

    def remote_shell_command_str(self) -> str:
        return "/bin/sh"


class SSHCommandRunner(CommandRunnerInterface):
    """Exec on a remote machine over ssh (reference SSHCommandRunner):
    BatchMode + ControlMaster multiplexing + IdentityFile, rsync for
    file sync. ``exec_fn`` defaults to a real subprocess launcher and
    is injectable for argv-contract tests."""

    SSH_OPTS = [
        "-o", "BatchMode=yes",
        "-o", "StrictHostKeyChecking=no",
        "-o", "UserKnownHostsFile=/dev/null",
        "-o", "ConnectTimeout=10",
        "-o", "ControlMaster=auto",
        "-o", "ControlPersist=60s",
    ]

    def __init__(self, host: str, user: str = "", port: int = 22,
                 ssh_key: Optional[str] = None,
                 control_path: Optional[str] = None,
                 exec_fn: Optional[ExecFn] = None):
        self.host = host
        self.user = user
        self.port = port
        self.ssh_key = ssh_key
        self.control_path = control_path or os.path.join(
            os.path.expanduser("~"), ".ray_tpu_torch", "ssh_sockets",
            f"{user or 'x'}@{host}:{port}")
        os.makedirs(os.path.dirname(self.control_path), exist_ok=True)
        self._exec: ExecFn = exec_fn or (
            lambda argv: _default_exec(argv))

    @property
    def _target(self) -> str:
        return f"{self.user}@{self.host}" if self.user else self.host

    def _ssh_base(self) -> List[str]:
        argv = ["ssh"] + list(self.SSH_OPTS)
        argv += ["-o", f"ControlPath={self.control_path}"]
        argv += ["-p", str(self.port)]
        if self.ssh_key:
            argv += ["-i", self.ssh_key]
        return argv

    def run(self, cmd: str, timeout: float = 300.0) -> Tuple[int, str]:
        argv = self._ssh_base() + [self._target,
                                   f"bash -lc {_shquote(cmd)}"]
        rc, out, _err = self._exec(argv)
        return rc, out

    def _rsync(self, src: str, dst: str) -> None:
        argv = ["rsync", "-az", "-e", " ".join(self._ssh_base()),
                src, dst]
        rc, _out, err = self._exec(argv)
        if rc != 0:
            raise RuntimeError(f"rsync failed rc={rc}: {err}")

    def run_rsync_up(self, source: str, target: str) -> None:
        self._rsync(source, f"{self._target}:{target}")

    def run_rsync_down(self, source: str, target: str) -> None:
        self._rsync(f"{self._target}:{source}", target)

    def remote_shell_command_str(self) -> str:
        return " ".join(self._ssh_base() + [self._target])


def _shquote(s: str) -> str:
    import shlex

    return shlex.quote(s)
