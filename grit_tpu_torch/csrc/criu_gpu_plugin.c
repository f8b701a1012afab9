/* CRIU plugin for a GPU pod whose workload runs the port's agentlet.
 *
 * The port's counterpart of the JAX package's CRIU TPU plugin, with the
 * same hook slots:
 *
 *   PAUSE_DEVICES        exec `gpu-checkpoint --quiesce --pid`: the
 *                        workload's agentlet parks the training loop at a
 *                        step boundary while its threads still run.
 *   CHECKPOINT_DEVICES   exec `gpu-checkpoint --dump` into
 *                        $GRIT_TPU_IMAGE_DIR (or CRIU's image dir) /tpu:
 *                        the device snapshot lies beside the CRIU images.
 *   RESUME_DEVICES_LATE  exec `gpu-checkpoint --resume`.
 *   DUMP_EXT_FILE        refuses an fd open on an NVIDIA device node
 *                        (/dev/nvidia*, /dev/nvidiactl, /dev/nvidia-uvm,
 *                        /dev/nvidia-caps/...), loudly: a line on stderr
 *                        and a negative errno other than -ENOTSUP, so CRIU
 *                        fails the dump rather than hand the fd to another
 *                        plugin. Any other fd is not ours (-ENOTSUP).
 *   RESTORE_EXT_FILE     reopens nothing (-ENOTSUP).
 *
 * Where the TPU plugin records /dev/accel* fds and reopens them by path on
 * restore (a TPU device node is a stateless handle), a CUDA fd cannot be
 * reopened: the context behind it lives in the driver and is gone with the
 * process. The device state travels in the agentlet's snapshot instead,
 * and a fresh process restores it (GRIT_TPU_RESTORE_DIR). The CLI's path
 * comes from GRIT_TPU_CHECKPOINT_BIN; a pod without an agentlet has no
 * device state to pause, dump or resume, and those hooks return 0.
 *
 * Built with the host C compiler at first use
 * (grit_tpu_torch/device/native.py); a test dlopens it and drives the hooks.
 */

#include "criu_plugin_api.h"

#include <errno.h>
#include <fcntl.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/types.h>
#include <sys/wait.h>
#include <unistd.h>

static const char kDefaultCli[] = "gpu-checkpoint";

static const char *cli_path(void) {
  const char *p = getenv("GRIT_TPU_CHECKPOINT_BIN");
  return (p && *p) ? p : kDefaultCli;
}

/* The directory the device snapshot goes under. CRIU hands plugins its
 * image dir as an fd (criu_get_image_dir); $GRIT_TPU_IMAGE_DIR overrides
 * it, as outside CRIU (a test) there is none. */
static int image_dir_fd(void) {
  const char *dir = getenv("GRIT_TPU_IMAGE_DIR");
  if (dir && *dir) return open(dir, O_RDONLY | O_DIRECTORY);
  if (criu_get_image_dir) return criu_get_image_dir();
  return -1;
}

static int run_cli(const char *const argv[]) {
  pid_t child = fork();
  if (child < 0) return -errno;
  if (child == 0) {
    execvp(argv[0], (char *const *)argv);
    _exit(127);
  }
  int status = 0;
  while (waitpid(child, &status, 0) < 0) {
    if (errno != EINTR) return -errno;
  }
  if (WIFEXITED(status) && WEXITSTATUS(status) == 0) return 0;
  return -EIO;
}

static int toggle(const char *action, int pid, const char *dir) {
  char pidbuf[32];
  snprintf(pidbuf, sizeof(pidbuf), "%d", pid);
  const char *argv[8];
  int n = 0;
  argv[n++] = cli_path();
  argv[n++] = action;
  argv[n++] = "--pid";
  argv[n++] = pidbuf;
  if (dir) {
    argv[n++] = "--dir";
    argv[n++] = dir;
  }
  argv[n] = NULL;
  return run_cli(argv);
}

/* Whether `path` names an NVIDIA device node: /dev/nvidia<N>,
 * /dev/nvidiactl, and the /dev/nvidia-* family (uvm, uvm-tools, modeset,
 * nvswitch, the nvidia-caps directory). Exported, so a test checks it
 * without a device node. */
int grit_gpu_is_nvidia_device(const char *path) {
  static const char kPrefix[] = "/dev/nvidia";
  const size_t n = sizeof(kPrefix) - 1;
  if (!path || strncmp(path, kPrefix, n) != 0) return 0;
  const char *rest = path + n;
  if (*rest >= '0' && *rest <= '9') {
    while (*rest >= '0' && *rest <= '9') rest++;
    return *rest == '\0';
  }
  if (!strcmp(rest, "ctl")) return 1;
  return rest[0] == '-' && rest[1] != '\0';
}

/* ------------------------------------------------------------------------ */
/* Hooks */

static int gpu_plugin_init(int stage) {
  (void)stage;
  return 0;
}

static void gpu_plugin_fini(int stage, int ret) {
  (void)stage;
  (void)ret;
}

/* PAUSE_DEVICES(pid): park the loop before CRIU freezes the tree. */
static int gpu_plugin_pause_devices(int pid) {
  if (toggle("--status", pid, NULL) != 0)
    return 0; /* no agentlet: a CPU-only pod, nothing to pause */
  return toggle("--quiesce", pid, NULL);
}

/* CHECKPOINT_DEVICES(pid): dump the device state beside the CRIU images. */
static int gpu_plugin_checkpoint_devices(int pid) {
  if (toggle("--status", pid, NULL) != 0) return 0;
  const char *dir = getenv("GRIT_TPU_IMAGE_DIR");
  char pathbuf[4096];
  if (dir && *dir) {
    snprintf(pathbuf, sizeof(pathbuf), "%s/tpu", dir);
  } else {
    int fd = image_dir_fd();
    if (fd < 0) return -EINVAL;
    char link[64];
    snprintf(link, sizeof(link), "/proc/self/fd/%d", fd);
    ssize_t n = readlink(link, pathbuf, sizeof(pathbuf) - 5);
    int saved = errno;
    close(fd);
    if (n <= 0) return n < 0 ? -saved : -EINVAL;
    pathbuf[n] = '\0';
    strncat(pathbuf, "/tpu", sizeof(pathbuf) - strlen(pathbuf) - 1);
  }
  return toggle("--dump", pid, pathbuf);
}

/* RESUME_DEVICES_LATE(pid): unpark after a leave-running dump. */
static int gpu_plugin_resume_devices_late(int pid) {
  if (toggle("--status", pid, NULL) != 0) return 0;
  return toggle("--resume", pid, NULL);
}

/* DUMP_EXT_FILE(fd, id): CRIU asks for fds it cannot handle itself. */
static int gpu_plugin_dump_ext_file(int fd, int id) {
  char link[64], path[4096];
  snprintf(link, sizeof(link), "/proc/self/fd/%d", fd);
  ssize_t n = readlink(link, path, sizeof(path) - 1);
  if (n <= 0) return -ENOTSUP;
  path[n] = '\0';
  if (!grit_gpu_is_nvidia_device(path)) return -ENOTSUP; /* not ours */
  fprintf(stderr,
          "grit_gpu_plugin: refusing to dump fd %d (id %d) open on %s: a "
          "CUDA device fd cannot be reopened by path; the device state "
          "travels in the agentlet's snapshot and a fresh process restores "
          "it\n",
          fd, id, path);
  fflush(stderr);
  return -EPERM;
}

/* RESTORE_EXT_FILE(id): nothing of this plugin is reopened. */
static int gpu_plugin_restore_ext_file(int id) {
  (void)id;
  return -ENOTSUP;
}

cr_plugin_desc_t CR_PLUGIN_DESC = {
    /* name      */ "grit_gpu_plugin",
    /* init      */ gpu_plugin_init,
    /* exit      */ gpu_plugin_fini,
    /* version   */ CRIU_PLUGIN_VERSION_V2,
    /* max_hooks */ CR_PLUGIN_HOOK__MAX,
    /* hooks     */ {
        NULL,                                   /* DUMP_UNIX_SK */
        NULL,                                   /* RESTORE_UNIX_SK */
        (void *)gpu_plugin_dump_ext_file,       /* DUMP_EXT_FILE */
        (void *)gpu_plugin_restore_ext_file,    /* RESTORE_EXT_FILE */
        NULL,                                   /* DUMP_EXT_MOUNT */
        NULL,                                   /* RESTORE_EXT_MOUNT */
        NULL,                                   /* DUMP_EXT_LINK */
        NULL,                                   /* HANDLE_DEVICE_VMA */
        NULL,                                   /* UPDATE_VMA_MAP */
        (void *)gpu_plugin_resume_devices_late, /* RESUME_DEVICES_LATE */
        (void *)gpu_plugin_pause_devices,       /* PAUSE_DEVICES */
        (void *)gpu_plugin_checkpoint_devices,  /* CHECKPOINT_DEVICES */
    },
};
