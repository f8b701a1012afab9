/* CRIU's public plugin ABI (criu >= 3.19 "V2" plugins), declared here so
 * the port's plugin builds with the host C compiler on a node without
 * CRIU's development headers. Written against the documented interface
 * (criu.org/Plugins and the criu-plugin.h a deployment host installs).
 * The order of the hook enum and the layout of the descriptor are ABI:
 * do not reorder them.
 */
#ifndef GRIT_GPU_CRIU_PLUGIN_API_H
#define GRIT_GPU_CRIU_PLUGIN_API_H

#ifdef __cplusplus
extern "C" {
#endif

enum {
  CR_PLUGIN_HOOK__DUMP_UNIX_SK = 0,
  CR_PLUGIN_HOOK__RESTORE_UNIX_SK = 1,
  CR_PLUGIN_HOOK__DUMP_EXT_FILE = 2,
  CR_PLUGIN_HOOK__RESTORE_EXT_FILE = 3,
  CR_PLUGIN_HOOK__DUMP_EXT_MOUNT = 4,
  CR_PLUGIN_HOOK__RESTORE_EXT_MOUNT = 5,
  CR_PLUGIN_HOOK__DUMP_EXT_LINK = 6,
  CR_PLUGIN_HOOK__HANDLE_DEVICE_VMA = 7,
  CR_PLUGIN_HOOK__UPDATE_VMA_MAP = 8,
  CR_PLUGIN_HOOK__RESUME_DEVICES_LATE = 9,
  CR_PLUGIN_HOOK__PAUSE_DEVICES = 10,
  CR_PLUGIN_HOOK__CHECKPOINT_DEVICES = 11,
  CR_PLUGIN_HOOK__MAX
};

/* init is called with the stage: 0 = dump, 1 = pre-restore, 2 = restore. */
enum {
  CR_PLUGIN_STAGE__DUMP = 0,
  CR_PLUGIN_STAGE__PRE_RESTORE = 1,
  CR_PLUGIN_STAGE__RESTORE = 2
};

typedef int(cr_plugin_init_t)(int stage);
typedef void(cr_plugin_fini_t)(int stage, int ret);

#define CRIU_PLUGIN_VERSION_V2 2

typedef struct {
  const char *name;
  cr_plugin_init_t *init;
  cr_plugin_fini_t *exit;
  int version;
  int max_hooks;
  void *hooks[CR_PLUGIN_HOOK__MAX];
} cr_plugin_desc_t;

/* Services CRIU exports to plugins; weak, so a test can dlopen the plugin
 * without providing them. */
extern int criu_get_image_dir(void) __attribute__((weak));

#ifdef __cplusplus
}
#endif

#endif /* GRIT_GPU_CRIU_PLUGIN_API_H */
